"""TAC (Think-Answer Consistency) evaluation.

A copy of ``video_r2_tpu/evalharness/tac.py`` (jax-free);
tests/test_torch_posthoc.py holds the two source-equal.

Parity: eval/scripts/tac/ — three lenses per sample (mvbench.py:1-28):
  (1) harness accuracy replay (accuracy field in the samples JSONL),
  (2) judge-parsed <answer> accuracy,
  (3) judge-extracted <think>-conclusion accuracy ("LAST explicit conclusion
      wins"),
plus the answer<->thinking correlation/confusion summary (mvbench.py:339-362)
and the consistency metric mixer (post_processing/summarize_tac.py:22-46).
Judge is injected (deterministic decoding is the caller's judge config).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..rewards.judge import JudgeClient
from ..rewards.parsing import extract_answer, extract_reasoning

# Judge prompts are metric DATA: they define what TAC measures, so they are
# byte-identical to the reference (eval/scripts/tac/_utils.py:4-86, typo
# "parsing agen." and the A–Z en-dash included); a fixture test pins them
# against the reference file. Paraphrasing here = silent metric drift.
ANSWER_PARSE_SYSTEM = (
    "You are a deterministic parsing agen.\n"
    "Task: Read ONLY the provided text and emit a SINGLE-LINE answer in the exact format requested.\n"
    "Hard rules (apply all):\n"
    "1) Do not infer or reason beyond the text. If the text lacks a valid answer, output exactly: UNKNOWN\n"
    "2) Output must contain no explanations, no extra words, no labels, no code fences, no quotes, no brackets.\n"
    "3) Strip leading/trailing whitespace. No trailing punctuation unless it is required by the format (e.g., a % sign).\n"
    "4) Normalize internal whitespace to single spaces.\n"
    "5) Treat case-insensitive tokens like 'option c', '(c)', '[c]', 'C)' as the letter C when MCQ is requested.\n"
)

THINK_EXTRACT_SYSTEM = (
    "You are a strict extractor.\n"
    "Your ONLY job is to read the Reasoning text appended at the end of the user message and output a SINGLE LETTER "
    "corresponding to the option that the Reasoning explicitly concludes as the final answer.\n\n"
    "Rules (follow in order):\n"
    "1) Look ONLY at the Reasoning text. Ignore the options text, and any non-Reasoning content for decision-making.\n"
    "2) If the Reasoning contains an explicit final choice (e.g., 'Therefore, D', 'So the answer is C', 'I choose B', 'Answer: A', 'Option D is correct'), "
    "output that letter. If multiple explicit finals appear, output the LAST one.\n"
    "3) If there is no explicit 'final choice' sentence, but the Reasoning clearly labels a single option as correct using letter notation (e.g., 'D is correct'), "
    "output that letter. If multiple appear, output the LAST one.\n"
    "4) If the Reasoning states the correct option by its text (e.g., 'the correct answer is \"Girl in green clothing with braided hair\"'), "
    "match that text EXACTLY to the provided options and output the corresponding LETTER. If multiple such matches appear, output the LAST one.\n"
    "5) Do NOT judge correctness yourself. Do NOT infer from descriptions. Do NOT vote or reason beyond what the Reasoning states. "
    "If the Reasoning contradicts itself, prefer the LAST explicit conclusion it gives.\n"
    "6) Output only a single uppercase letter that exists in the provided options (A, B, C, ...). No punctuation, no words, no explanations.\n"
)

_MCQ_OUTPUT_FORMAT = (
    "MCQ output format:\n"
    "- Return ONLY one capital letter A–Z on a single line.\n"
    "- Do NOT include any other characters or spaces.\n"
)

_OPEN_OUTPUT_FORMAT = (
    "Open-form output format:\n"
    "- If the correct answer is numeric, return ONLY the number (digits, optional decimal). "
    "- If it's text, return ONLY the minimal text answer."
    "- Output must be a single line with no extra characters.\n"
)

# Numeric (NA) extraction prompts — byte-identical to the reference's
# build_extraction_message_numeric (eval/scripts/tac/vsibench.py:168-179).
NUMERIC_EXTRACT_SYSTEM = (
    "You are a careful extractor. Based ONLY on the provided content, "
    "return the final numeric answer with no extra words."
)


def numeric_extract_user(payload_text: str) -> str:
    return (
        "Text to parse:\n" + (payload_text.strip() if payload_text else "") + "\n\n"
        "Return ONLY the number (digits, optional decimal) on a single line."
    )


# ---------------------------------------------------------------------------
# Open-form parsing & scoring (tac/vsibench.py:36-163, tac/mmvu.py:107-162)
# ---------------------------------------------------------------------------

# Numeric token with optional commas/decimal/sign/currency (vsibench.py:36-38)
RE_NUMBER = re.compile(
    r"[-+]?[\$€£]?\s*(?:\d{1,3}(?:,\d{3})+|\d+)(?:\.\d+)?(?:[eE][-+]?\d+)?\s*%?"
)


def parse_number(text: Optional[str]) -> Optional[float]:
    """First numeric token in free text -> float (vsibench.py:83-98)."""
    if not text:
        return None
    m = RE_NUMBER.search(text)
    if not m:
        return None
    t = (m.group(0).replace(",", "").replace("$", "").replace("€", "")
         .replace("£", "").strip())
    if t.endswith("%"):
        t = t[:-1].strip()
    try:
        return float(t)
    except Exception:
        return None


def safe_float(x) -> Optional[float]:
    try:
        return float(x)
    except Exception:
        return parse_number(str(x)) if x is not None else None


def tac_mean_relative_accuracy(pred: Optional[float], target: Optional[float],
                               start: float = 0.5, end: float = 0.95,
                               interval: float = 0.05) -> float:
    """Proportion of c in [start,end] s.t. |pred-target|/|target| <= 1-c
    (vsibench.py:138-157 — NOTE a slightly different confidence grid from the
    harness-side MRA in tasks/common.py, kept faithful to each source)."""
    if pred is None or target is None or target == 0:
        return 0.0
    c_vals = []
    c = start
    while c <= end + 1e-9:
        c_vals.append(c)
        c += interval
    err = abs(pred - target) / abs(target)
    return sum(1 for c in c_vals if err <= (1.0 - c)) / len(c_vals)


def mra_bool_at_5pct(pred: Optional[float], target: Optional[float]) -> bool:
    """Booleanize MRA at the tightest 5% band (vsibench.py:159-163)."""
    if pred is None or target is None or target == 0:
        return False
    return abs(pred - target) / abs(target) <= 0.05


def _normalize_text(s: str) -> str:
    return re.sub(r"\s+", " ", re.sub(r"[\W_]+", " ", str(s).lower())).strip()


def compare_open_ended(pred: str, gt: str) -> bool:
    """mmvu open-ended comparison: numeric equality rounded to two decimals,
    else lenient normalized substring/equality (tac/mmvu.py:121-162)."""
    pa, pb = safe_float(pred), safe_float(gt)
    if pa is not None and pb is not None and round(pa, 2) == round(pb, 2):
        return True
    p, g = _normalize_text(pred or ""), _normalize_text(gt or "")
    if not p or not g:
        return False
    return p == g or p in g or g in p


def answer_parse_user(options: Optional[list[str]], content: str,
                      is_mcq: bool = True) -> str:
    if is_mcq:
        opts = ""
        if options:
            opts = ("Options:\n" + "\n".join(
                f"{chr(ord('A') + i)}. {o}" for i, o in enumerate(options))
                + "\n\n")
        return (opts + "Text to parse (final answer snippet):\n"
                + (content.strip() if content else "") + "\n\n"
                + _MCQ_OUTPUT_FORMAT)
    return ("Text to parse (final answer snippet):\n"
            + (content.strip() if content else "") + "\n\n"
            + _OPEN_OUTPUT_FORMAT)


def think_extract_user(options: Optional[list[str]], thinking: str,
                       is_mcq: bool = True) -> str:
    if is_mcq:
        opts = ("Options:\n" + "\n".join(
            f"{chr(ord('A') + i)}. {o}" for i, o in enumerate(options or []))
            + "\n\n")
        return (opts + "Reasoning:\n"
                + (thinking.strip() if thinking else "") + "\n"
                + "\n\n" + _MCQ_OUTPUT_FORMAT)
    return ("Reasoning:\n" + (thinking.strip() if thinking else "")
            + "\n\n" + _OPEN_OUTPUT_FORMAT)


def extract_letter(text: str) -> str:
    """First standalone A-Z letter in the judge's one-line output."""
    if not text:
        return ""
    t = text.strip().splitlines()[0].strip()
    if t.upper() == "UNKNOWN":
        return ""
    m = re.search(r"\b([A-Z])\b", t.upper())
    return m.group(1) if m else ""


@dataclass
class TACSampleResult:
    doc_id: int
    lmms_correct: bool
    answer_correct: bool
    thinking_correct: bool
    answer_letter: str        # parsed prediction (letter / number / text)
    thinking_letter: str
    gt_letter: str            # GT (letter for mcq; raw string otherwise)
    mode: str = "mcq"         # "mcq" | "mra" | "open"
    lmms_score: float = 0.0   # type-appropriate score in [0,1]
    answer_score: float = 0.0
    thinking_score: float = 0.0


def default_get_gt_raw(row: dict) -> str:
    """Raw GT string for open-form rows (vsibench.py:267-268, mmvu.py:353)."""
    doc = row.get("doc", {}) or {}
    gt = doc.get("answer", doc.get("ground_truth", row.get("target", "")))
    return str(gt) if gt is not None else ""


def evaluate_tac_samples(
    rows: list[dict],
    judge: JudgeClient,
    get_options,          # row -> list[str] | None
    get_gt_letter,        # row -> str (mcq rows only)
    is_mcq: bool = True,
    get_mode=None,        # row -> "mcq" | "mra" | "open" (overrides is_mcq)
    get_gt_raw=default_get_gt_raw,  # row -> str (non-mcq rows)
) -> tuple[list[TACSampleResult], dict]:
    """rows: harness per-sample JSONL dicts (resps/filtered_resps contract).

    Three modes, routed per row (reference: type-aware tac/vsibench.py,
    tac/mmvu.py; plain-MCQ scripts for the rest):
      mcq  — judge-parse a letter from <answer>/<think>, exact letter match.
      mra  — judge-extract a number, score by mean relative accuracy
             (vsibench NA types); booleanized at the 5% band for correlation.
      open — judge-parse minimal text, numeric-eq-at-2-decimals or lenient
             normalized text match (mmvu open-ended).
    """
    from ..rewards.judge import chat_many

    # Phase 1: build every judge message, mode-routed, in row order
    # (answer-parse then think-extract per row). Phase 2: ONE batched judge
    # run — the reference's single-batch vLLM generate (vsibench.py:337-341
    # run_llm_simple + slot stitching); against our continuous engine the
    # concurrent requests share one decode loop.
    prepared = []
    requests: list[tuple[str, str]] = []
    for row in rows:
        mode = get_mode(row) if get_mode else ("mcq" if is_mcq else "open")
        resp = row.get("filtered_resps", [""])
        while isinstance(resp, list):
            resp = resp[0] if resp else ""
        answer_txt = extract_answer(resp)
        think_txt = extract_reasoning(resp)
        if mode == "mra":
            requests.append((NUMERIC_EXTRACT_SYSTEM,
                             numeric_extract_user(answer_txt)))
            requests.append((NUMERIC_EXTRACT_SYSTEM,
                             numeric_extract_user(think_txt)))
        elif mode == "open":
            requests.append((ANSWER_PARSE_SYSTEM,
                             answer_parse_user(None, answer_txt, False)))
            requests.append((THINK_EXTRACT_SYSTEM,
                             think_extract_user(None, think_txt, False)))
        else:
            requests.append((ANSWER_PARSE_SYSTEM,
                             answer_parse_user(get_options(row), answer_txt,
                                               True)))
            requests.append((THINK_EXTRACT_SYSTEM,
                             think_extract_user(get_options(row), think_txt)))
            # resolve (and loud-fail) the GT letter BEFORE the judge batch:
            # an unroutable row must not cost the whole file's judge calls
            get_gt_letter(row)
        prepared.append((row, mode))
    outs = chat_many(judge, requests)

    results = []
    for i, (row, mode) in enumerate(prepared):
        a_out, t_out = outs[2 * i], outs[2 * i + 1]
        lmms_score = float(row.get("accuracy", 0) or 0)

        if mode == "mra":
            a_num, t_num = parse_number(a_out), parse_number(t_out)
            gt = get_gt_raw(row)
            gt_f = safe_float(gt)
            a_score = tac_mean_relative_accuracy(a_num, gt_f)
            t_score = tac_mean_relative_accuracy(t_num, gt_f)
            results.append(TACSampleResult(
                doc_id=row.get("doc_id", -1),
                # lmms accuracy is itself an MRA; ==1.0 iff within the 5% band
                lmms_correct=lmms_score >= 1.0 - 1e-9,
                answer_correct=mra_bool_at_5pct(a_num, gt_f),
                thinking_correct=mra_bool_at_5pct(t_num, gt_f),
                answer_letter="" if a_num is None else repr(a_num),
                thinking_letter="" if t_num is None else repr(t_num),
                gt_letter=gt, mode=mode, lmms_score=lmms_score,
                answer_score=a_score, thinking_score=t_score))
            continue

        if mode == "open":
            gt = get_gt_raw(row)
            a_ok = compare_open_ended(a_out.strip(), gt)
            t_ok = compare_open_ended(t_out.strip(), gt)
            results.append(TACSampleResult(
                doc_id=row.get("doc_id", -1),
                lmms_correct=lmms_score >= 1.0 - 1e-9,
                answer_correct=a_ok, thinking_correct=t_ok,
                answer_letter=a_out.strip(), thinking_letter=t_out.strip(),
                gt_letter=gt, mode=mode, lmms_score=lmms_score,
                answer_score=float(a_ok), thinking_score=float(t_ok)))
            continue

        a_letter, t_letter = extract_letter(a_out), extract_letter(t_out)
        gt = get_gt_letter(row)
        results.append(TACSampleResult(
            doc_id=row.get("doc_id", -1),
            lmms_correct=bool(lmms_score),
            answer_correct=a_letter == gt,
            thinking_correct=t_letter == gt,
            answer_letter=a_letter, thinking_letter=t_letter, gt_letter=gt,
            mode=mode, lmms_score=lmms_score,
            answer_score=float(a_letter == gt),
            thinking_score=float(t_letter == gt)))
    return results, summarize_tac(results)


def summarize_tac(results: list[TACSampleResult]) -> dict:
    """Pooled type-appropriate scores (each sample contributes MRA for NA or
    accuracy for MCQ/open — vsibench.py:429-444); correlation/combos use the
    booleanized lenses."""
    n = max(len(results), 1)
    acc_l = sum(r.lmms_score for r in results) / n
    acc_a = sum(r.answer_score for r in results) / n
    acc_t = sum(r.thinking_score for r in results) / n
    both = sum(r.answer_correct and r.thinking_correct for r in results) / n
    neither = sum((not r.answer_correct) and (not r.thinking_correct)
                  for r in results) / n
    a_only = sum(r.answer_correct and not r.thinking_correct for r in results) / n
    t_only = sum(r.thinking_correct and not r.answer_correct for r in results) / n
    corr = sum(r.answer_correct == r.thinking_correct for r in results) / n
    modes: dict[str, int] = {}
    for r in results:
        modes[r.mode] = modes.get(r.mode, 0) + 1
    return {
        "num_samples": len(results),
        "modes": modes,
        "lmms_accuracy": acc_l,
        "answer_accuracy": acc_a,
        "thinking_accuracy": acc_t,
        "both_correct": both,
        "neither_correct": neither,
        "answer_only_correct": a_only,
        "thinking_only_correct": t_only,
        "answer_to_thinking_correlation": corr,
    }


def consistency_metrics(summary: dict, alpha: float = 0.7,
                        gamma: float = 2.0) -> dict:
    """post_processing/summarize_tac.py:22-46 parity: consistency score,
    signed disagreement, nonlinear mixer, consistency accuracy."""
    A = summary["answer_accuracy"]
    T = summary["thinking_accuracy"]
    corr = summary["answer_to_thinking_correlation"]
    both = summary["both_correct"]
    t_only = summary["thinking_only_correct"]
    sign = 1.0 if T >= A else -1.0
    denom = min(A, T) if min(A, T) > 0 else 1.0
    mixer = sign * (alpha * (1 - corr ** gamma) + (1 - alpha) * (1 - corr))
    tp, fn = both, t_only
    return {
        "consistency_score": (T - A) / denom,
        "signed_disagreement": sign * (1 - corr),
        "nonlinear_consistency": mixer,
        "consistency_accuracy": tp / (tp + fn) if (tp + fn) > 0 else 0.0,
    }


def run_tac_on_rows(rows: list[dict], judge: JudgeClient,
                    get_options, get_gt_letter, out_dir: str | Path,
                    is_mcq: bool = True, get_mode=None,
                    get_gt_raw=default_get_gt_raw,
                    extra_summary: dict | None = None) -> dict:
    """Skip-if-done rows-level entry; mvbench's pooled directory mode feeds
    concatenated shards through here (tac/_run_all_benchmarks.py:207-232)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    summary_path = out_dir / "summary.json"
    if summary_path.exists():
        return json.load(open(summary_path))
    results, summary = evaluate_tac_samples(rows, judge, get_options,
                                            get_gt_letter, is_mcq,
                                            get_mode=get_mode,
                                            get_gt_raw=get_gt_raw)
    summary.update(consistency_metrics(summary))
    if extra_summary:
        summary.update(extra_summary)
    with open(out_dir / "per_sample.jsonl", "w") as f:
        for r in results:
            f.write(json.dumps(r.__dict__) + "\n")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def run_tac_on_file(samples_path: str | Path, judge: JudgeClient,
                    get_options, get_gt_letter, out_dir: str | Path,
                    is_mcq: bool = True, get_mode=None,
                    get_gt_raw=default_get_gt_raw) -> dict:
    """Skip-if-done file-level entry (tac/_run_all_benchmarks.py parity)."""
    out_dir = Path(out_dir)
    summary_path = out_dir / "summary.json"
    if summary_path.exists():
        return json.load(open(summary_path))
    rows = [json.loads(l) for l in open(samples_path) if l.strip()]
    return run_tac_on_rows(rows, judge, get_options, get_gt_letter, out_dir,
                           is_mcq, get_mode=get_mode, get_gt_raw=get_gt_raw)
