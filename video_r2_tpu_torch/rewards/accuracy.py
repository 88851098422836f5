"""Accuracy reward: the question type inferred from the ground-truth answer
routes to its scorer.

A copy of ``video_r2_tpu/rewards/accuracy.py`` (its package ``__init__``
imports jax); tests/test_torch_host.py holds every function and class
here equal to the original's source.
"""

from __future__ import annotations

from .parsing import (
    compute_rouge_score,
    extract_answer,
    infer_question_type,
    normalize_mcq,
    normalize_number,
    wer,
)


def accuracy_reward(completions, assistant, **kwargs) -> list[float]:
    solutions = [a["content"] for a in assistant]
    contents = [c[0]["content"] for c in completions]
    rewards = []
    for content, sol in zip(contents, solutions):
        try:
            out_ans = extract_answer(content)
            gt_ans = extract_answer(sol)
            qtype = infer_question_type(gt_ans)
            if qtype == "multiple choice":
                reward = 1.0 if normalize_mcq(out_ans) == normalize_mcq(gt_ans) else 0.0
            elif qtype == "numerical":
                # decimal-format guard: mismatch in decimal/comma presence = 0
                if (("." in gt_ans) or ("," in gt_ans)) != (
                        ("." in out_ans) or ("," in out_ans)):
                    reward = 0.0
                else:
                    g, o = normalize_number(gt_ans), normalize_number(out_ans)
                    reward = (1.0 if g is not None and o is not None
                              and round(g, 2) == round(o, 2) else 0.0)
            elif qtype == "OCR":
                reward = max(0.0, min(1.0, 1 - wer(gt_ans, out_ans)))
            elif qtype == "free-form":
                reward = max(0.0, min(1.0, compute_rouge_score(gt_ans, out_ans)))
            elif qtype == "regression":
                g, o = normalize_number(gt_ans), normalize_number(out_ans)
                if g is None or o is None:
                    reward = 0.0
                else:
                    rel = (abs(o - g) + 1e-9) / (abs(g) + 1e-9)
                    reward = max(0.0, min(1.0, 1 - rel))
            else:
                reward = 0.0
        except Exception:
            reward = 0.0
        rewards.append(reward)
    return rewards
