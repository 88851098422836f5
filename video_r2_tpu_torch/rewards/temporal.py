"""The temporal-alignment (TAR) reward: grounding claims extracted from a
completion, matched against the ground-truth timeline by time and by
sentence similarity, and judged for consistency.

A copy of ``video_r2_tpu/rewards/temporal.py`` (its package ``__init__``
imports jax); tests/test_torch_host.py holds every function and class
here equal to the original's source.
"""

from __future__ import annotations

import ast
import json
import re
from typing import Optional

import numpy as np

from .embedding import cos_sim, load_embedder
from .judge import JudgeClient
from .parsing import extract_answer, extract_reasoning, parse_decision

_TIME_SEP = re.compile(r"\s*(?:-|–|—|to)\s*", re.IGNORECASE)


def _to_seconds(ts: str) -> int:
    parts = [int(p) for p in ts.strip().split(":")]
    if len(parts) == 3:
        return parts[0] * 3600 + parts[1] * 60 + parts[2]
    if len(parts) == 2:
        return parts[0] * 60 + parts[1]
    raise ValueError(f"Unsupported timestamp format: {ts}")


def _normalize_ts(ts: str) -> str:
    parts = [int(p) for p in ts.strip().split(":")]
    if len(parts) == 3:
        return f"{parts[0]:02d}:{parts[1]:02d}:{parts[2]:02d}"
    if len(parts) == 2:
        return f"{parts[0]:02d}:{parts[1]:02d}"
    raise ValueError(f"Unsupported timestamp format: {ts}")


def _to_seconds_loose(token: str) -> Optional[int]:
    if token is None:
        return None
    t = token.strip().strip("+.,").lower()
    if t in {"end", "eof"}:
        return None
    if ":" in t:
        parts = t.split(":")
        try:
            if len(parts) == 3:
                h, m, s = int(parts[0]), int(parts[1]), float(parts[2])
            elif len(parts) == 2:
                h, m, s = 0, int(parts[0]), float(parts[1])
            else:
                return None
            return int(round(h * 3600 + m * 60 + s))
        except ValueError:
            return None
    try:
        return int(t)
    except ValueError:
        try:
            return int(round(float(t)))
        except ValueError:
            return None


def _seconds_to_key(sec: int) -> str:
    if sec >= 3600:
        return f"{sec // 3600:02d}:{(sec % 3600) // 60:02d}:{sec % 60:02d}"
    return f"{sec // 60:02d}:{sec % 60:02d}"


def sanitize_timestamps_dict(d: dict, drop_open_ended: bool = True,
                             coerce_open_ended_by: Optional[int] = None) -> dict:
    """Normalize keys to zero-padded MM:SS / HH:MM:SS (ranges hyphenated);
    drop or coerce open-ended ranges."""
    out = {}
    for k, v in d.items():
        if not isinstance(k, str):
            continue
        parts = _TIME_SEP.split(k.strip())
        if len(parts) == 1:
            start = _to_seconds_loose(parts[0])
            if start is None:
                continue
            end = start
        elif len(parts) == 2:
            start = _to_seconds_loose(parts[0])
            if start is None:
                continue
            end = _to_seconds_loose(parts[1])
            if end is None:
                if drop_open_ended and coerce_open_ended_by is None:
                    continue
                end = start + (coerce_open_ended_by or 0)
        else:
            continue
        if end < start:
            start, end = end, start
        key = (_seconds_to_key(start) if start == end
               else f"{_seconds_to_key(start)}-{_seconds_to_key(end)}")
        out[key] = v
    return out


def extract_grounding_claims(raw: str | dict) -> list[dict]:
    """{timestamp(-range): sentence} -> sorted claim dicts."""
    if isinstance(raw, dict):
        data = raw
    else:
        try:
            data = json.loads(raw.strip())
        except Exception:
            try:
                data = ast.literal_eval(raw.strip())
            except Exception:
                return []
    if not isinstance(data, dict):
        return []
    claims = []
    for key, sentence in data.items():
        key = str(key).strip()
        sentence = (sentence or "").strip()
        if not sentence:
            continue
        try:
            if "-" in key:
                s_raw, e_raw = (p.strip() for p in key.split("-", 1))
                s, e = _to_seconds(s_raw), _to_seconds(e_raw)
                claims.append({
                    "timestamp_str": f"{_normalize_ts(s_raw)}-{_normalize_ts(e_raw)}",
                    "timestamp_sec": (s + e) / 2,
                    "start_sec": s, "end_sec": e,
                    "sentence": sentence, "is_range": True,
                })
            else:
                s = _to_seconds(key)
                claims.append({
                    "timestamp_str": _normalize_ts(key), "timestamp_sec": s,
                    "start_sec": s, "end_sec": s,
                    "sentence": sentence, "is_range": False,
                })
        except ValueError:
            continue
    claims.sort(key=lambda c: c["timestamp_sec"])
    return claims


def _temporal_match(p: dict, g: dict, buf: float) -> bool:
    ps, pe = int(p["start_sec"]), int(max(p["end_sec"], p["start_sec"]))
    gs, ge = int(g["start_sec"]), int(max(g["end_sec"], g["start_sec"]))
    return (ps - buf <= ge + buf) and (gs - buf <= pe + buf)


def robust_json_from_text(text: str) -> dict:
    try:
        return json.loads(text)
    except Exception:
        pass
    start, end = text.find("{"), text.rfind("}")
    if start != -1 and end > start:
        try:
            return json.loads(text[start: end + 1])
        except Exception:
            return {}
    return {}


# The extraction prompts are metric/reward DATA: byte-identical to the
# reference (train/src/train/temporal_grounding_reward.py:264-318); a
# fixture test pins them against the reference file.
EXTRACTION_SYSTEM = '\nYou are a precise temporal information extraction assistant.\n\nGoal:\nGiven ONLY the provided text, extract every timestamp mention and produce a compact JSON object mapping each timestamp (key) to ONE short sentence (value) describing what happens at that time according to the text.\n\nOutput format (STRICT):\n- Return ONLY a JSON object. No prose, no code fences, no explanations.\n- Keys: timestamps exactly as mentioned, normalized to MM:SS or HH:MM:SS with leading zeros.\n  • Single time example: "00:42"\n  • Range examples: "00:42-00:45", "01:45-02:01"\n- Order keys by start time ascending.\n- If the text uses phrases like "around the 16-second mark" or "at about 1:02", convert to "00:16" or "01:02".\n- If a single continuous action is described across adjacent times (e.g., 00:07 and 00:08), you MAY consolidate into a range "00:07-00:08" with one concise sentence.\n- If the same timestamp appears multiple times, merge into a single key and summarize succinctly.\n- If no timestamps are present, return {}.\n\nContent rules:\n- Derive sentences ONLY from the given text. No hallucinations.\n- Each value is a brief, plain-language clause (≤ 10 words), sentence case, ending with a period.\n- Prefer action-focused wording (“Performer executes a cartwheel while holding the jump rope.”).\n'

EXTRACTION_USER = '\nExtract timestamped events from the following text and return ONLY the JSON object as specified.\n\nSTRICT KEYS FORMAT:\n- Use ONLY zero-padded MM:SS or HH:MM:SS.\n- For ranges, use a single hyphen: "MM:SS-HH:MM:SS".\n- Do NOT output plain seconds without a colon (e.g., "6" or "020" is forbidden).\n- Do NOT output words like "end", "EOF", "+", or any trailing symbols.\n- If the text mentions decimal seconds (e.g., 01.77s or 3.5s), round to the nearest second BEFORE emitting.\n- Normalize phrases like "around 16 seconds" to "00:16".\n- Keys must be unique and ordered by start time ascending.\n- If no timestamps are present, return {{}} exactly.\n\nVALUES:\n- Each value is ONE short clause (≤ 10 words), sentence case, action-focused, ends with a period.\n- Derive strictly from the provided text (no hallucinations).\n\nReturn ONLY the JSON object. No prose, no code fences, no explanations.\n\nThe text:\n{text}\n'

CONSISTENCY_SYSTEM = (
    "You are a meticulous auditor. Determine whether the reasoning (THINK) "
    "and the final answer (ANSWER) are logically consistent with each other "
    "for the given question. Ignore style, verbosity, or extra details; focus "
    "strictly on whether the conclusion in THINK matches and supports the "
    "final ANSWER for the same question."
)

# Verbatim from reward_funcs.py:122-134 (user_msg), as a .format template.
CONSISTENCY_USER = (
    "QUESTION:\n"
    "{question}\n\n"
    "THINK (model's internal reasoning):\n"
    "{think}\n\n"
    "ANSWER (model's final answer):\n"
    "{answer}\n\n"
    "TASK:\n"
    "1) Output ONLY one of the TRUE or FALSE on the first line.\n"
    "   - TRUE  => THINK and ANSWER are consistent and the same conclusion.\n"
    "   - FALSE => THINK contradicts or does not support the ANSWER (e.g., mismatched conclusion).\n"
    "2) On the next line(s), give a brief justification (1-3 sentences)."
)


def calculate_grounding_reward(
    prediction_text: str,
    temporal_grnd: dict,
    judge: JudgeClient,
    embedder=None,
    buffer_seconds: float = 2,
    similarity_threshold: float = 0.75,
    extraction_out: str | None = None,
) -> float:
    """matches / |predicted claims| with one-to-one greedy matching.

    extraction_out: a pre-fetched judge response for the extraction prompt
    (the batched TAR path issues all extraction calls in one chat_many)."""
    embedder = embedder or load_embedder()
    think = extract_reasoning(prediction_text)
    if extraction_out is None:
        extraction_out = judge.chat(EXTRACTION_SYSTEM,
                                    EXTRACTION_USER.format(text=think))
    extracted = robust_json_from_text(extraction_out)
    if isinstance(extracted, dict):
        extracted = sanitize_timestamps_dict(extracted)
    if isinstance(temporal_grnd, dict):
        temporal_grnd = sanitize_timestamps_dict(temporal_grnd)

    pred = extract_grounding_claims(extracted)
    gt = extract_grounding_claims(temporal_grnd)
    if not pred or not gt:
        return 0.0
    pred_s = [c["sentence"] for c in pred]
    gt_s = [c["sentence"] for c in gt]
    if not any(pred_s) or not any(gt_s):
        return 0.0
    pe = np.asarray(embedder.encode(pred_s))
    ge = np.asarray(embedder.encode(gt_s))

    matches, used = 0, set()
    for i, pc in enumerate(pred):
        candidates = [j for j, gc in enumerate(gt)
                      if j not in used and _temporal_match(pc, gc, buffer_seconds)]
        best_j, best_sim = None, -1.0
        for j in candidates:
            sim = cos_sim(pe[i], ge[j])
            if sim >= similarity_threshold and sim > best_sim:
                best_sim, best_j = sim, j
        if best_j is not None:
            used.add(best_j)
            matches += 1
    return float(matches / max(1, len(pred)))


def temporal_grounding_sentence_embedding_consistency_reward(
    completions, assistant, temporal_grounding, prompts=None, judge=None,
    embedder=None, buffer_seconds: float = 2, similarity_threshold: float = 0.75,
    **kwargs,
) -> list[float]:
    """TAR = consistency(0/1) x grounding score.
    Parity: reward_funcs.py:91-154."""
    questions = []
    for p in (prompts or [None] * len(completions)):
        q = ""
        if p:
            # last text element of the user turn
            user = next((m for m in p if m.get("role") == "user"), None)
            if user and isinstance(user.get("content"), list):
                texts = [e.get("text", "") for e in user["content"]
                         if e.get("type") == "text"]
                q = texts[-1] if texts else ""
            elif user:
                q = str(user.get("content", ""))
        questions.append(q)

    # Both judge roles batch across the whole rollout group: extraction
    # prompts first, then consistency prompts (each role's calls are
    # independent across completions — against the continuous judge engine
    # they share one decode loop instead of 2xBxG serial HTTP round-trips).
    from .judge import chat_many

    extraction_reqs, consistency_reqs = [], []
    for question, completion, _tg in zip(questions, completions,
                                         temporal_grounding):
        prediction = completion[0]["content"]
        reasoning = extract_reasoning(prediction)
        ans = extract_answer(prediction)
        # reference passes the extracted thinking UNstripped
        # (temporal_grounding_reward.py:311-316)
        extraction_reqs.append((EXTRACTION_SYSTEM,
                                EXTRACTION_USER.format(text=reasoning)))
        consistency_reqs.append((CONSISTENCY_SYSTEM, CONSISTENCY_USER.format(
            question=question.strip() if question else "(none)",
            think=reasoning.strip() if reasoning else "(missing)",
            answer=ans.strip() if ans else "(missing)")))
    # per-row degradation: a failed judge call zeroes THAT row's reward
    # (reference reward_funcs.py:70-72 try/except-0), never the whole group
    extraction_outs = chat_many(judge, extraction_reqs, on_error="empty")
    consistency_outs = chat_many(judge, consistency_reqs, on_error="empty")

    rewards = []
    for completion, tg, ext, cons in zip(completions, temporal_grounding,
                                         extraction_outs, consistency_outs):
        try:
            prediction = completion[0]["content"]
            grounding = calculate_grounding_reward(
                prediction, tg, judge, embedder,
                buffer_seconds, similarity_threshold, extraction_out=ext)
            out = cons if cons is not None else ""
            decision, _ = parse_decision(out)
            rewards.append((1 if decision is True else 0) * grounding)
        except Exception:
            rewards.append(0.0)
    return rewards
