"""Post-hoc pipeline tooling: TAC dispatcher, summarizers, VSIBench
prediction post-processing.

A copy of ``video_r2_tpu/evalharness/postprocess.py`` (jax-free);
tests/test_torch_posthoc.py holds the two source-equal.

Parity surfaces:
- tac/_run_all_benchmarks.py: scan a predictions tree for *samples*.jsonl,
  route by benchmark-name regex, skip-if-summary-exists, consolidated
  all_summaries.json.
- post_processing/summarize_tac.py: recursive latest-wins aggregation +
  consistency metric family (the mixer math lives in tac.consistency_metrics).
- post_processing/summarize_vas.py: mean of per-sample scores across files.
- post_processing/post_process_vsibench_predictions.py: free-form -> MCA
  letter / NA float normalization with number words, judge-assisted.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

from ..rewards.judge import JudgeClient
from .tac import consistency_metrics, run_tac_on_file, run_tac_on_rows
from .vas import run_vas_on_file, run_vas_on_rows_files

BENCH_PATTERNS = [
    # order matters: longest/most specific first (video_mmmu before mmvu)
    ("video_mmmu", r"video_?mmmu"),
    ("videomathqa", r"videomathqa"),
    ("videomme", r"videomme"),
    ("longvideobench", r"longvideobench"),
    ("scivideobench", r"scivideobench"),
    ("tempcompass", r"tempcompass"),
    ("mvbench", r"mvbench"),
    ("minerva", r"min[ve]?erva|minverva"),
    ("vsibench", r"vsibench"),
    ("mlvu", r"mlvu"),
    ("mmvu", r"mmvu"),
]


def route_benchmark(name: str) -> Optional[str]:
    low = name.lower()
    for bench, pat in BENCH_PATTERNS:
        if re.search(pat, low):
            return bench
    return None


def discover_sample_files(predictions_dir: str | Path) -> dict[str, list[Path]]:
    """benchmark -> sample JSONL files under the tree."""
    out: dict[str, list[Path]] = {}
    for p in sorted(Path(predictions_dir).rglob("*samples*.jsonl")):
        bench = route_benchmark(p.name) or route_benchmark(str(p.parent))
        if bench:
            out.setdefault(bench, []).append(p)
    return out


def default_get_options(row: dict):
    """Options list from the sample's doc, per benchmark schema."""
    doc = row.get("doc", {})
    if "candidates" in doc:                        # mvbench
        return list(doc["candidates"])
    if isinstance(doc.get("options"), list):       # videomme/videomathqa/...
        # strip any 'A. ' style prefixes so the judge prompt re-letters them
        out = []
        for o in doc["options"]:
            m = re.match(r"^\s*[A-Ea-e][\.\):]\s*(.*)$", str(o))
            out.append(m.group(1) if m else str(o))
        return out
    if isinstance(doc.get("choices"), dict):       # mmvu
        return [doc["choices"][k] for k in sorted(doc["choices"])]
    cands = [doc.get(f"option{i}") for i in range(5)]  # longvideobench
    cands = [c for c in cands if c not in (None, "N/A")]
    return cands or None


def default_get_gt_letter(row: dict) -> str:
    """GT option letter from the doc: letter answers pass through, option-text
    answers resolve against the option list.

    Raises on non-letter GT that resolves to no option: an MCQ lens fed an
    open-form row (e.g. numeric GT "42") must fail loudly, not silently score
    letter "4" — route such benchmarks through ``get_mode`` instead
    (tac/vsibench.py NA types, tac/mmvu.py open-ended)."""
    doc = row.get("doc", {})
    answer = str(doc.get("answer", doc.get("ground_truth",
                                           row.get("target", ""))))
    m = re.match(r"^\s*\(?([A-Ea-e])\)?[\.\):]?\s*$", answer)
    if m:
        return m.group(1).upper()
    m = re.match(r"^\s*([A-Ea-e])[\.\):]\s+", answer)
    if m:
        return m.group(1).upper()
    options = default_get_options(row) or []
    for i, opt in enumerate(options):
        if str(opt).strip().lower() == answer.strip().lower():
            return chr(ord("A") + i)
    raise ValueError(
        f"non-letter ground truth {answer!r} on an MCQ-lens TAC row "
        f"(doc_id={row.get('doc_id')}); open-form benchmarks must be routed "
        "via get_mode ('mra'/'open'), see get_mode_for_bench()")


def _vsibench_mode(row: dict) -> str:
    """vsibench: NA question types get the numeric/MRA lens; MCA get letters;
    unknown types fall back to numeric, as the reference does
    (tac/vsibench.py:319-335)."""
    from .tasks.benchmarks import VSI_MCA_TYPES

    qtype = (row.get("doc", {}) or {}).get("question_type", "")
    return "mcq" if qtype in VSI_MCA_TYPES else "mra"


def _mmvu_mode(row: dict) -> str:
    """mmvu: multiple-choice if declared or choices present, else open-ended
    (tac/mmvu.py:144-150)."""
    doc = row.get("doc", {}) or {}
    qtype = str(doc.get("question_type", "")).lower()
    if qtype == "multiple-choice" or doc.get("choices"):
        return "mcq"
    return "open"


def get_mode_for_bench(bench: str):
    """Per-benchmark TAC mode router (None = all-MCQ benchmark)."""
    return {"vsibench": _vsibench_mode, "mmvu": _mmvu_mode}.get(bench)


def run_all_tac(predictions_dir: str | Path, judge: JudgeClient,
                out_root: str | Path,
                get_options=default_get_options,
                get_gt_letter=default_get_gt_letter,
                ) -> dict:
    """TAC over every discovered benchmark file; skip-if-done per file;
    consolidated all_summaries.json. mvbench's 20 shard files are pooled
    into ONE directory-mode evaluation (tac/_run_all_benchmarks.py:56-59,
    207-232) with per-shard counts recorded alongside the pooled summary."""
    import logging

    out_root = Path(out_root)
    all_summaries: dict[str, dict] = {}
    # one benchmark's failure must not torch the rest: the reference runs
    # each benchmark in its own subprocess (_run_all_benchmarks.py:186-232);
    # here failures are recorded loudly in all_summaries and the loop goes on
    for bench, files in discover_sample_files(predictions_dir).items():
        mode_fn = get_mode_for_bench(bench)
        try:
            if bench == "mvbench":
                rows, per_shard = [], {}
                for f in files:
                    shard_rows = [json.loads(l) for l in open(f) if l.strip()]
                    per_shard[f.stem] = len(shard_rows)
                    rows.extend(shard_rows)
                summary = run_tac_on_rows(
                    rows, judge, get_options, get_gt_letter, out_root / bench,
                    get_mode=mode_fn, extra_summary={"shards": per_shard})
                all_summaries[bench] = {"__directory__": summary}
                continue
            for f in files:
                out_dir = out_root / bench / f.stem
                summary = run_tac_on_file(f, judge, get_options,
                                          get_gt_letter, out_dir,
                                          get_mode=mode_fn)
                all_summaries.setdefault(bench, {})[f.stem] = summary
        except Exception as e:  # noqa: BLE001
            logging.getLogger(__name__).exception("TAC failed for %s", bench)
            all_summaries[bench] = {"error": f"{type(e).__name__}: {e}"}
    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / "all_summaries.json", "w") as fp:
        json.dump(all_summaries, fp, indent=2)
    return all_summaries


def run_all_vas(predictions_dir: str | Path, judge: JudgeClient,
                out_root: str | Path, dry_run: bool = False) -> dict:
    """VAS over discovered benchmarks; mvbench shards concatenate into one
    pooled evaluation (evaluate_vas.py:274-293)."""
    out_root = Path(out_root)
    summaries: dict[str, dict] = {}
    for bench, files in discover_sample_files(predictions_dir).items():
        if bench == "mvbench":  # always pooled, like TAC: one summary shape
            summaries[bench] = {"__directory__": run_vas_on_rows_files(
                files, judge, out_root / bench, bench=bench,
                dry_run=dry_run)}
            continue
        for f in files:
            summaries.setdefault(bench, {})[f.stem] = run_vas_on_file(
                f, judge, out_root / bench, bench=f.stem, dry_run=dry_run)
    if dry_run:  # plan only: no outputs written, judge never contacted
        return summaries
    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / "vas_summaries.json", "w") as fp:
        json.dump(summaries, fp, indent=2)
    return summaries


def summarize_tac_tree(root: str | Path) -> dict:
    """Recursively aggregate summary.json files, latest-wins per dataset
    (summarize_tac.py:14-21), attaching the consistency metric family."""
    by_dataset: dict[str, tuple[float, dict]] = {}
    for p in Path(root).rglob("summary.json"):
        name = p.parent.name
        m = re.match(r"(?:samples_)?([a-z_0-9]+?)(?:_think.*)?$", name)
        dataset = m.group(1) if m else name
        mtime = p.stat().st_mtime
        if dataset not in by_dataset or mtime > by_dataset[dataset][0]:
            by_dataset[dataset] = (mtime, json.load(open(p)))
    out = {}
    for dataset, (_, summary) in by_dataset.items():
        entry = dict(summary)
        if "answer_accuracy" in summary:
            entry.update(consistency_metrics(summary))
        out[dataset] = entry
    return out


def summarize_vas_tree(root: str | Path) -> dict:
    """Mean __attention_to_video_score per per_sample*.jsonl
    (summarize_vas.py parity)."""
    out = {}
    for p in Path(root).rglob("per_sample*.jsonl"):
        scores = [json.loads(l).get("__attention_to_video_score", 0)
                  for l in open(p) if l.strip()]
        if scores:
            out[p.stem] = {"mean_score": sum(scores) / len(scores),
                           "num_samples": len(scores)}
    if out:
        total = [s for v in out.values()
                 for s in [v["mean_score"]] * v["num_samples"]]
        out["__overall__"] = {"mean_score": sum(total) / len(total),
                              "num_samples": len(total)}
    return out


# ---------------------------------------------------------------------------
# VSIBench prediction post-processing
# ---------------------------------------------------------------------------

_NUMBER_WORDS = {"zero": 0, "one": 1, "two": 2, "three": 3, "four": 4,
                 "five": 5, "six": 6, "seven": 7, "eight": 8, "nine": 9,
                 "ten": 10, "eleven": 11, "twelve": 12}


def extract_option_letter(text: str, options: list[str] | None = None) -> Optional[str]:
    """Free-form MCA prediction -> option letter (post_process_vsibench:57-80)."""
    if not text:
        return None
    t = text.strip()
    m = re.match(r"^\s*([A-Da-d])(\b|[\.\):\-\s])", t)
    if m:
        return m.group(1).upper()
    if len(t) == 1 and t.upper() in "ABCD":
        return t.upper()
    if options:
        bodies = {}
        for opt in options:
            m2 = re.match(r"^\s*([A-Da-d])\s*[\.\):-]\s*(.*)$", (opt or "").strip())
            if m2:
                bodies[m2.group(1).upper()] = m2.group(2).strip().lower()
        low = t.lower()
        for letter, body in bodies.items():
            if body and (body in low or low in body):
                return letter
    return None


def parse_na_number(text: str) -> Optional[float]:
    """Free-form NA prediction -> float (digits or number words)."""
    if not text:
        return None
    t = text.strip().lower()
    m = re.search(r"[-+]?\d+(?:\.\d+)?", t.replace(",", ""))
    if m:
        try:
            return float(m.group(0))
        except ValueError:
            pass
    for word, val in _NUMBER_WORDS.items():
        if re.search(rf"\b{word}\b", t):
            return float(val)
    return None


def postprocess_vsibench_row(row: dict, judge: JudgeClient | None = None) -> dict:
    """Normalize one sample row's prediction; falls back to the judge for
    unparseable free-form answers when one is provided."""
    doc = row.get("doc", {})
    qtype = doc.get("question_type", "")
    pred = row.get("filtered_resps", [""])
    while isinstance(pred, list):
        pred = pred[0] if pred else ""
    from .tasks.benchmarks import VSI_MCA_TYPES

    if qtype in VSI_MCA_TYPES:
        letter = extract_option_letter(pred, doc.get("options"))
        if letter is None and judge is not None:
            out = judge.chat(
                "You map free-form answers to multiple-choice letters. "
                "Reply with ONLY one letter A-D, or UNKNOWN.",
                f"Options:\n" + "\n".join(doc.get("options", []))
                + f"\n\nAnswer text:\n{pred}")
            letter = extract_option_letter(out)
        return {**row, "parsed_prediction": letter}
    value = parse_na_number(pred)
    if value is None and judge is not None:
        out = judge.chat(
            "You convert free-form answers to a single number. Interpret "
            "number words: zero=0, one=1, two=2, three=3, four=4, five=5, "
            "six=6, seven=7, eight=8, nine=9, ten=10. Reply with ONLY the "
            "number, or UNKNOWN.",
            f"Answer text:\n{pred}")
        value = parse_na_number(out)
    return {**row, "parsed_prediction": value}
