"""Shared task helpers: answer extraction, MCQ scoring, option formatting.

A copy of ``video_r2_tpu/evalharness/tasks/common.py``; tests/test_torch_eval.py holds
the two equal.

Parity: lmms_eval.utils.extract_answer (:1021-1026 — falls back to the WHOLE
text when no <answer> tag) and mvbench_think/utils.py mcq_acc.
"""

from __future__ import annotations

import re
import string


def extract_answer(text: str) -> str:
    """<answer>..</answer> content, else the full text (reference parity —
    different from rewards.parsing.extract_answer which returns '')."""
    m = re.search(r"<answer>(.*?)</answer>", text, re.DOTALL)
    return m.group(1).strip() if m else text


_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
          "-", ">", "<", "@", "`", ",", "?", "!"]


def _process_punct(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or _COMMA_STRIP.search(text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def _norm_option(answer: str) -> str:
    m = re.match(r"^([A-E])\.\s*(.+)$", answer.strip(), re.IGNORECASE)
    if m:
        return m.group(1).upper()
    a = answer.replace("\n", " ").replace("\t", " ").strip()
    a = _process_punct(a)
    a = a.strip("'").strip('"').strip(")").strip("(").strip().lower()
    letter = re.search(r"\b([A-E])\b", a, re.IGNORECASE)
    if letter:
        return letter.group(1).upper()
    return a


def mcq_acc(answer: str, pred: str) -> int:
    """mvbench_think/utils.py mcq_acc parity."""
    return 1 if _norm_option(pred) == _norm_option(answer) else 0


def letter_options_prompt(options: list[str], paren: bool = True) -> str:
    """(A) opt\n(B) opt... (paren=True: mvbench style) or A. opt style."""
    letters = string.ascii_uppercase
    if paren:
        return "".join(f"({letters[i]}) {o}\n" for i, o in enumerate(options))
    return "\n".join(f"{letters[i]}. {o}" for i, o in enumerate(options))


def first_letter(text: str, valid: str = "ABCDE") -> str:
    """First standalone option letter in text."""
    m = re.search(rf"\b([{valid}])\b", text.strip(), re.IGNORECASE)
    return m.group(1).upper() if m else ""


_ANSWER_PREFIXES = [
    "The best answer is", "The correct answer is", "The answer is",
    "The answer", "The best option is", "The correct option is",
    "Best answer:", "Best option:",
]


def extract_characters_regex(s: str) -> str:
    """MLVU/VideoMME-style option-letter extraction
    (mlvu_think/utils.py:75-112 parity)."""
    s = s.strip()
    for prefix in _ANSWER_PREFIXES:
        if s.startswith(prefix):
            s = s[len(prefix):].strip()
    m = re.match(r"^\(?([A-E])\)?[:.]?", s)
    if m:
        return m.group(1)
    if len(s.split()) <= 10:
        m = re.search(r"\b([A-E])\b", s)
        if m:
            return m.group(1)
    if ")" in s:
        idx = s.index(")")
        if idx > 0 and s[idx - 1].upper() in "ABCDE":
            return s[idx - 1].upper()
    return s


def fuzzy_first_word(pred: str) -> str:
    """vsibench fuzzy_matching parity."""
    return pred.split(" ")[0].rstrip(".").strip()


def to_float(x) -> float | None:
    try:
        return float(x)
    except Exception:
        return None


def abs_dist_norm(pred: float, target: float) -> float:
    return abs(pred - target) / abs(target)


def mean_relative_accuracy(pred: float, target: float, start: float = 0.5,
                           end: float = 0.95, interval: float = 0.05) -> float:
    """vsibench MRA:.5:.95:.05 parity."""
    import numpy as np

    num_pts = (end - start) / interval + 2
    confs = np.linspace(start, end, int(num_pts))
    return float((abs_dist_norm(pred, target) <= 1 - confs).mean())
