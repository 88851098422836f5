"""Answer / reasoning extraction and question-type inference.

A copy of ``video_r2_tpu/rewards/parsing.py`` (its package ``__init__``
imports jax); tests/test_torch_host.py holds every function and class
here equal to the original's source.
"""

from __future__ import annotations

import re


def extract_answer(text: str) -> str:
    m = re.search(r"<answer>\s*(.*?)\s*</answer>", text, re.DOTALL)
    return m.group(1).strip() if m else ""


def extract_reasoning(text: str) -> str:
    m = re.search(r"<think>\s*(.*?)\s*</think>", text, re.DOTALL)
    return m.group(1).strip() if m else ""


def normalize_number(num_str: str) -> float | None:
    try:
        return float(num_str.replace(",", ""))
    except Exception:
        return None


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate via Levenshtein distance over words."""
    ref, hyp = reference.split(), hypothesis.split()
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur[j] = prev[j - 1]
            else:
                cur[j] = 1 + min(prev[j], cur[j - 1], prev[j - 1])
        prev = cur
    return prev[n] / max(1, m)


def compute_rouge_score(reference: str, hypothesis: str,
                        use_stemmer: bool = True) -> float:
    """Mean of ROUGE-1/2/L f-measures."""
    from rouge_score import rouge_scorer

    scorer = rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"],
                                      use_stemmer=use_stemmer)
    s = scorer.score(reference, hypothesis)
    return (s["rouge1"].fmeasure + s["rouge2"].fmeasure + s["rougeL"].fmeasure) / 3


def infer_question_type(answer: str) -> str:
    """multiple choice | numerical | regression | OCR | free-form."""
    ans = answer.strip()
    if re.match(r"^[A-Ea-e][\.\)]?\s*(.*)", ans):
        return "multiple choice"
    if re.fullmatch(r"[-+]?\d{1,3}(,\d{3})*(\.\d+)?", ans) or re.fullmatch(
            r"[-+]?\d+(\.\d+)?", ans):
        if "." in ans and len(ans.split(".")[-1]) > 3:
            return "regression"
        return "numerical"
    if len(ans.split()) <= 5 and re.fullmatch(r"[A-Za-z0-9\s\-:]+", ans):
        return "OCR"
    return "free-form"


def normalize_mcq(ans: str) -> str:
    m = re.match(r"([A-Ea-e])", ans.strip())
    return m.group(1).upper() if m else ans.strip()


def parse_decision(text: str) -> tuple[bool | None, str]:
    """First line TRUE/FALSE -> (decision, justification)."""
    if not text:
        return None, ""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        return None, ""
    first = lines[0].upper()
    rest = "\n".join(lines[1:]).strip()
    if first.startswith("TRUE"):
        return True, rest
    if first.startswith("FALSE"):
        return False, rest
    if "TRUE" in first and "FALSE" not in first:
        return True, rest
    if "FALSE" in first and "TRUE" not in first:
        return False, rest
    return None, rest
