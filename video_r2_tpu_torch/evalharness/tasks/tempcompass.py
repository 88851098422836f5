"""TempCompass task-type variants: multi_choice, yes_no, caption_matching,
captioning.

A copy of ``video_r2_tpu/evalharness/tasks/tempcompass.py``; tests/test_torch_eval.py holds
the two equal.

Parity: eval/lmms-eval/lmms_eval/tasks/tempcompass_think/utils.py —
hand-crafted matching rules first, with an optional judge fallback replacing
the reference's ChatGPT call (get_eval_result). The captioning variant is
judge-scored entirely (caption quality has no rule-based path).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

from ..api import MetricSpec, Task, TaskConfig, THINK_POST_PROMPT, mean
from . import register_task
from .common import extract_answer


def mc_rating(pred: str, answer: str) -> Optional[int]:
    """Multi-choice matching rules (utils.py:134-142). None = rules failed."""
    if pred == answer:
        return 1
    if pred in ("A", "B", "C", "D"):
        return 1 if pred == answer[0] else 0
    if any(pred.startswith(p) for p in ("A.", "B.", "C.", "D.")):
        return 1 if pred.split(".")[0] == answer[0] else 0
    if any(pred.startswith(p) for p in ("A)", "B)", "C)", "D)")):
        return 1 if pred.split(")")[0] == answer[0] else 0
    return None


def yes_no_pred(text: str) -> Optional[str]:
    low = text.lower()
    if low.startswith("yes"):
        return "yes"
    if low.startswith("no"):
        return "no"
    return None


def caption_matching_rating(pred: str, question: str, answer: str) -> Optional[int]:
    """Word-matching rules for caption_matching (utils.py:439-458)."""
    option_strs = question.split("\n")[1:]
    option_sents = [o.split(": ")[1] for o in option_strs if ": " in o]
    option_inds = ([o.split(": ")[0] for o in option_strs]
                   + [o.split(": ")[0].replace("Sentence ", "")
                      .replace("Option ", "").replace("Caption ", "")
                      for o in option_strs])
    matched = None
    for o in option_strs:
        if o == pred:
            matched = o
    for s in option_sents:
        if s == pred or (") " in pred and s == pred.split(") ")[1]):
            matched = s
    for ind in option_inds:
        if ind == pred or ind == pred.replace(".", ""):
            matched = ind
    if matched is None:
        return None
    ans_parts = {answer, answer.split(":")[0]}
    if ": " in answer:
        ans_parts.add(answer.split(": ")[1])
    head = answer.split(": ")[0].split()
    if len(head) > 1:
        ans_parts.add(head[1])
    return 1 if matched in ans_parts else 0


_JUDGE_PROMPT = (
    "You will receive a {kind} question, the ground-truth answer and the "
    "prediction from a question answering (QA) model. Your task is to "
    "determine whether QA model prediction is correct, based on the question "
    "and ground-truth answer. If the prediction is correct, respond "
    '"Correct". If the prediction is incorrect, respond "Incorrect".\n'
    "{kind} question:\n{question}\nGround-Truth Answer: {answer}\n"
    "Model Prediction: {pred}")


def _judge_rating(judge, kind, question, answer, pred) -> int:
    if judge is None:
        return 0
    try:
        out = judge.chat("", _JUDGE_PROMPT.format(
            kind=kind, question=question, answer=answer, pred=pred))
        return 1 if "incorrect" not in out.lower() and "correct" in out.lower() else 0
    except Exception:
        return 0


def make_tempcompass_task(task_type: str, think: bool, docs=None,
                          dataset_path=None, judge=None) -> Task:
    name = f"tempcompass_{task_type}" + ("_think" if think else "")

    def doc_to_text(doc):
        return doc["question"]

    def process_results(doc, results):
        pred = extract_answer(results[0])
        if task_type == "multi_choice":
            r = mc_rating(pred, doc["answer"])
            if r is None:
                r = _judge_rating(judge, "multi-choice", doc["question"],
                                  doc["answer"], pred)
        elif task_type == "yes_no":
            yn = yes_no_pred(pred)
            if yn is not None:
                r = 1 if yn == doc["answer"] else 0
            else:
                r = _judge_rating(judge, "Yes/No", doc["question"],
                                  doc["answer"], pred)
        elif task_type == "caption_matching":
            r = caption_matching_rating(pred, doc["question"], doc["answer"])
            if r is None:
                r = _judge_rating(judge, "caption matching", doc["question"],
                                  doc["answer"], pred)
        else:  # captioning: judge-scored
            r = _judge_rating(judge, "captioning", doc["question"],
                              doc.get("answer", ""), pred)
        return {"accuracy": r}

    cfg = TaskConfig(
        task=name, doc_to_text=doc_to_text,
        doc_to_visual=lambda d: [d["video"]],
        doc_to_target=lambda d: str(d.get("answer", "")),
        process_results=process_results,
        metrics=[MetricSpec("accuracy", mean)],
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0.0,
                           "do_sample": False},
        post_prompt=THINK_POST_PROMPT if think else "",
        dataset_path=dataset_path)
    return Task(cfg, docs=docs)


for _t in ("multi_choice", "yes_no", "caption_matching", "captioning"):
    register_task(f"tempcompass_{_t}", partial(make_tempcompass_task, _t, False))
    register_task(f"tempcompass_{_t}_think", partial(make_tempcompass_task, _t, True))


# --------------------------------------------------------------------------
# tempcompass_complete (+_think): the mmaaz60/tempcompass mcq split as ONE
# task (tasks/tempcompass_complete/tempcompass_complete.yaml:1-29,
# utils.py:22-46) — distinct from the 4 per-type tasks above: options come
# pre-lettered, videos resolve by video_id with extension fallback, and the
# metric is tempcompass_perception_score (100 * correct / answered).
# --------------------------------------------------------------------------

_COMPLETE_POST_PROMPT = (
    "Do not generate any intermediate thinking. \nAnswer with the option's "
    "letter (e.g., A, B, C, D, etc.) from the given choices directly.")
# tempcompass_complete_think/tempcompass_complete.yaml:25 prepends the
# letter instruction to the standard think suffix
_COMPLETE_THINK_POST_PROMPT = (
    "\nAnswer with the option's letter (e.g., A, B, C, D, etc.) from the "
    "given choices directly. " + THINK_POST_PROMPT)

_VIDEO_EXT_FALLBACK = (".mp4", ".MP4", ".mkv", ".webm")


def tempcompass_complete_doc_to_visual(doc):
    """doc['video_id'] + extension fallback under the task video root
    (utils.py:22-37; missing video raises instead of sys.exit)."""
    if "video" in doc:          # in-memory frames / explicit path (tests)
        return [doc["video"]]
    import os

    root = os.environ.get("TEMPCOMPASS_VIDEO_ROOT",
                          os.environ.get("VIDEO_EVAL_ROOT", ""))
    base = os.path.join(root, "videos", doc["video_id"])
    for ext in _VIDEO_EXT_FALLBACK:
        if os.path.exists(base + ext):
            return [base + ext]
    raise FileNotFoundError(
        f"video path:{base}.mp4 does not exist, please check {doc}")


def tempcompass_complete_doc_to_text(doc):
    # options arrive pre-lettered ("A. ..."); reference joins with newlines
    # and appends the post prompt after a newline (utils.py:40-46)
    return doc["question"] + "\n" + "\n".join(doc["options"]) + "\n"


def tempcompass_complete_process_results(doc, results):
    from .common import extract_characters_regex

    pred = extract_characters_regex(extract_answer(results[0]))
    # per-row accuracy rides along for the samples-JSONL contract (the TAC
    # lmms-replay lens reads it); the published metric is the score dict
    return {"accuracy": int(pred == doc["answer"]),
            "tempcompass_perception_score": {
                "uuid": doc["uuid"], "pred_answer": pred,
                "answer": doc["answer"]}}


def tempcompass_mcq_aggregate(results) -> float:
    """Overall accuracy x100 (utils.py:108-120)."""
    n = len(results)
    correct = sum(r["pred_answer"] == r["answer"] for r in results)
    return 100.0 * correct / n if n else 0.0


def tempcompass_multi_binary_aggregate(results) -> float:
    """All-correct-per-uuid accuracy x100 (utils.py:123-138) — shipped by
    the reference utils for the multi-binary split; kept for parity."""
    groups: dict = {}
    for r in results:
        groups.setdefault(r["uuid"], []).append(r)
    n = len(groups)
    correct = sum(all(g["pred_answer"] == g["answer"] for g in group)
                  for group in groups.values())
    return 100.0 * correct / n if n else 0.0


def make_tempcompass_complete_task(think: bool, docs=None,
                                   dataset_path=None) -> Task:
    cfg = TaskConfig(
        task="tempcompass_complete" + ("_think" if think else ""),
        doc_to_text=tempcompass_complete_doc_to_text,
        doc_to_visual=tempcompass_complete_doc_to_visual,
        doc_to_target=lambda d: str(d.get("answer", "")),
        process_results=tempcompass_complete_process_results,
        metrics=[MetricSpec("accuracy", mean),
                 MetricSpec("tempcompass_perception_score",
                            tempcompass_mcq_aggregate)],
        generation_kwargs={"max_new_tokens": 1024, "temperature": 0.0,
                           "do_sample": False},
        post_prompt=(_COMPLETE_THINK_POST_PROMPT if think
                     else _COMPLETE_POST_PROMPT),
        dataset_path=dataset_path)
    return Task(cfg, docs=docs)


register_task("tempcompass_complete",
              partial(make_tempcompass_complete_task, False))
register_task("tempcompass_complete_think",
              partial(make_tempcompass_complete_task, True))
