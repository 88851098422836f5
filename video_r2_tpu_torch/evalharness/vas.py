"""VAS (Video Attention Score): LLM-judged 0-10 scoring of *claimed* visual
grounding inside <think>.

A copy of ``video_r2_tpu/evalharness/vas.py`` (jax-free);
tests/test_torch_posthoc.py holds the two source-equal.

Parity: eval/scripts/vas/evaluate_vas.py — rubric system prompt + user
template, unified row parsing (filtered_resps/resps drill-down :85-114), JSON
parse with one retry then score 0 (:314-326), per-benchmark + overall summary
with score distribution (:349-376). Reference judge sampling: temp 0.7,
top_p 0.8, top_k 20, max 256 — the injected judge carries its own config.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from ..rewards.judge import JudgeClient

# Judge prompts are metric DATA: byte-identical to the reference
# (eval/scripts/vas/evaluate_vas.py:116-170, typographic quotes and all);
# a fixture test pins them against the reference file. Paraphrasing the
# rubric would silently redefine the published VAS metric.
SYSTEM_PROMPT = 'You are an expert judge of **claimed visual grounding** in video QA chain-of-thought.\nYou will receive an Input (question/options/prompt) and a model Response that includes <think>…</think> and <answer>…</answer> tags.\n\nYour task: Evaluate how much the reasoning inside <think> and </think> only *claims* to rely on concrete visual evidence from the video versus using text patterns, prior knowledge, or guessing. You do not have the video; score what the reasoning asserts, not whether those assertions are true or the final answer is correct.\n\nWhat counts as visual grounding signals (positive cues):\n- Concrete, specific references to visible entities and attributes (colors, positions, counts, on-screen text/OCR).\n- Spatio-temporal descriptions tied to the video (“first/then,” “left/right,” “foreground/background,” scene changes).\n- Actions/interactions clearly described as seen (“picks up,” “points at,” “walks behind”).\n- Visual logic chained to the question (“Because the sign reads ‘Gate B’ and the arrow points left…”).\n- Mentions like “the video shows,” “the video states,” or “the video indicates…” count as *moderate visual grounding* **if** they reference specific factual content (e.g., numbers, object names, or events), even without spatial detail.\n\nWhat counts as non-visual or weak grounding (negative cues):\n- Generic mentions of “the video” with no specific content (“the video talks about cars”).\n- Option pattern matching, stereotypes/common knowledge, or generic phrases (“based on the context,” “usually…”).\n- Restating the question or options with “I see” but no concrete visual detail.\n- Timestamp name-dropping without linked content, irrelevant flourish, or contradictions.\n\nEdge cases:\n- If multiple <think> blocks exist, judge the first.\n- If <think> is missing or empty → score 0.\n- Ignore <answer> when scoring.\n\nScoring (0–10, integer):\n- 10 (Excellent): Dense, highly specific, step-by-step visual reasoning directly addressing the question.\n- 7–9 (Strong): Clearly video-based with several specific claims tied to what’s shown, even if phrased verbally (“the video states…”).\n- 4–6 (Moderate): Claims to recall or cite specific video facts (numbers, entities, or comparisons) but lacks spatial or temporal detail.\n- 1–3 (Weak): Minimal visual content; mostly generic or option-pattern reasoning with only token mentions of the video.\n- 0 (None): No visual grounding; guessing, meta-reasoning only, or <think> absent.\n\nOutput: Return JSON only with keys "score" (0–10 integer) and "rationale" (2–3 concise sentences citing the most important cues; do not mention lack of video).\n'

USER_TEMPLATE = '\nEvaluate ATTENTION-TO-VIDEO in the model’s reasoning. Score only the text inside <think>…</think>, not the final <answer> and not answer correctness.\n\nYou do not have access to the video. Judge whether the reasoning *claims* to use concrete visual evidence (what is seen, where it appears, how it changes) versus relying on generic patterns, options, or prior knowledge.\n\nUse this rubric (0–10):\n- 10: Dense, specific visual descriptions (entities, attributes, counts, on-screen text, spatial relations, temporal order) directly supporting the question.\n- 7–9: Clearly video-based reasoning with multiple specific claims tied to what the video shows, even if phrased as “the video states…” or “the video shows…”.\n- 4–6: Claims to recall or cite specific video facts (numbers, labels, or entities) but lacks spatial or visual detail.\n- 1–3: Minimal visual content; generic “the video talks about…” or option-based logic.\n- 0: No visual grounding; guessing, meta-reasoning only, or missing <think> block.\n\nEdge handling: If <think> is missing/empty → score 0.\n\nInput:\n{input_text}\n\nResponse:\n{response_text}\n\nReply ONLY with JSON like: {{"score": <0-10 int>, "rationale": "..."}}\n'


def extract_response_text(row: dict) -> str:
    """filtered_resps/resps drill-down (evaluate_vas.py:85-114 parity)."""
    for key in ("filtered_resps", "resps"):
        if key in row:
            val = row[key]
            if isinstance(val, str):
                return val
            while isinstance(val, list):
                val = val[0] if val else ""
            if isinstance(val, str) and val:
                return val
    for key in ("response", "prediction", "raw_output", "pred_answer"):
        v = row.get(key)
        if isinstance(v, str) and v.strip():
            return v
    return ""


def parse_llm_json(text: str) -> tuple[Optional[int], str]:
    if not isinstance(text, str):
        return None, ""
    try:
        data = json.loads(text)
    except Exception:
        s, e = text.find("{"), text.rfind("}")
        if s == -1 or e <= s:
            return None, ""
        try:
            data = json.loads(text[s: e + 1])
        except Exception:
            return None, ""
    score = data.get("score")
    try:
        score = int(score)
    except Exception:
        return None, str(data.get("rationale", ""))
    return max(0, min(10, score)), str(data.get("rationale", ""))


@dataclass
class VASSample:
    doc_id: Any
    score: int
    rationale: str


def evaluate_vas_rows(rows: list[dict], judge: JudgeClient) -> tuple[list[VASSample], dict]:
    """One batched judge pass over all rows, then a batched retry pass for
    unparseable outputs, then score 0 (reference: single-batch vLLM
    generate, evaluate_vas.py:218 + retry :314-326)."""
    from ..rewards.judge import chat_many

    requests = []
    for row in rows:
        user = USER_TEMPLATE.format(
            input_text=row.get("input", "") or "",
            response_text=extract_response_text(row) or "")
        requests.append((SYSTEM_PROMPT, user))
    outs = chat_many(judge, requests)
    parsed = [parse_llm_json(o) for o in outs]

    retry_idx = [i for i, (s, _) in enumerate(parsed) if s is None]
    if retry_idx:
        retry_outs = chat_many(judge, [requests[i] for i in retry_idx])
        for i, o in zip(retry_idx, retry_outs):
            parsed[i] = parse_llm_json(o)

    samples = []
    for row, (score, rationale) in zip(rows, parsed):
        if score is None:
            score, rationale = 0, "unparseable judge output"
        samples.append(VASSample(row.get("doc_id"), score, rationale))
    return samples, summarize_vas(samples)


def summarize_vas(samples: list[VASSample]) -> dict:
    n = max(len(samples), 1)
    dist = {str(i): 0 for i in range(11)}
    for s in samples:
        dist[str(s.score)] += 1
    return {
        "num_samples": len(samples),
        "attention_to_video_score": sum(s.score for s in samples) / n,
        "score_distribution": dist,
    }


def run_vas_on_rows_files(files: list, judge: JudgeClient,
                          out_dir: str | Path, bench: str = "mvbench",
                          dry_run: bool = False) -> dict:
    """Pooled directory mode: concatenate shard files into ONE evaluation
    (evaluate_vas.py:274-293 mvbench shard concat) — one per_sample file and
    one summary whose sample count is the sum of the shards."""
    out_dir = Path(out_dir)
    shard_rows = [(Path(f), [json.loads(l) for l in open(f) if l.strip()])
                  for f in files]
    per_sample = out_dir / f"per_sample_{bench}.jsonl"
    if dry_run:
        return {"dry_run": True, "bench": bench,
                "files": [str(f) for f, _ in shard_rows],
                "rows": sum(len(r) for _, r in shard_rows),
                "out": str(per_sample), "skip": per_sample.exists()}
    out_dir.mkdir(parents=True, exist_ok=True)
    if per_sample.exists():  # skip-if-done (same summary shape as a fresh run)
        rows = [json.loads(l) for l in open(per_sample)]
        summary = summarize_vas([VASSample(r["doc_id"], r["score"],
                                           r.get("rationale", ""))
                                 for r in rows])
        summary["shards"] = {f.stem: len(rs) for f, rs in shard_rows}
        return summary
    rows = [r for _, rs in shard_rows for r in rs]
    samples, summary = evaluate_vas_rows(rows, judge)
    with open(per_sample, "w") as f:
        for s in samples:
            f.write(json.dumps({"doc_id": s.doc_id, "score": s.score,
                                "rationale": s.rationale,
                                "__attention_to_video_score": s.score}) + "\n")
    summary["shards"] = {f.stem: len(rs) for f, rs in shard_rows}
    with open(out_dir / f"summary_{bench}.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary


def run_vas_on_file(samples_path: str | Path, judge: JudgeClient,
                    out_dir: str | Path, bench: str = "bench",
                    dry_run: bool = False) -> dict:
    out_dir = Path(out_dir)
    if dry_run:  # execution plan without touching the judge
        # (evaluate_vas.py --dry_run, :235,340-347)
        n = sum(1 for l in open(samples_path) if l.strip())
        per_sample = out_dir / f"per_sample_{bench}.jsonl"
        return {"dry_run": True, "bench": bench, "file": str(samples_path),
                "rows": n, "out": str(per_sample),
                "skip": per_sample.exists()}
    out_dir.mkdir(parents=True, exist_ok=True)
    per_sample = out_dir / f"per_sample_{bench}.jsonl"
    if per_sample.exists():  # skip-if-done (evaluate_vas.py:268-273)
        rows = [json.loads(l) for l in open(per_sample)]
        return summarize_vas([VASSample(r["doc_id"], r["score"],
                                        r.get("rationale", "")) for r in rows])
    rows = [json.loads(l) for l in open(samples_path) if l.strip()]
    samples, summary = evaluate_vas_rows(rows, judge)
    with open(per_sample, "w") as f:
        for s in samples:
            f.write(json.dumps({"doc_id": s.doc_id, "score": s.score,
                                "rationale": s.rationale,
                                "__attention_to_video_score": s.score}) + "\n")
    with open(out_dir / f"summary_{bench}.json", "w") as f:
        json.dump(summary, f, indent=2)
    return summary
