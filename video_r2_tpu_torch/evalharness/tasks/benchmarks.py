"""The 11 Video-R2 benchmark task definitions (+ _think variants).

A copy of ``video_r2_tpu/evalharness/tasks/benchmarks.py``; tests/test_torch_eval.py holds
the two equal.

Doc schemas and prompt formats mirror the reference task packs
(eval/lmms-eval/lmms_eval/tasks/<name>_think/utils.py); videos resolve
relative to a per-task `video_root` (the reference resolves inside the HF
cache — here the root is explicit config). Docs load from
`dataset_path` (local json/jsonl or HF datasets id) per TaskConfig.
"""

from __future__ import annotations

import os
from functools import partial

from ..api import MetricSpec, Task, TaskConfig, THINK_POST_PROMPT, mean
from . import register_task
from .common import (
    extract_answer,
    extract_characters_regex,
    first_letter,
    fuzzy_first_word,
    letter_options_prompt,
    mcq_acc,
    mean_relative_accuracy,
    to_float,
)

MCQ_GEN_KWARGS = {"max_new_tokens": 1024, "temperature": 0.0, "do_sample": False}


def _video_resolver(video_key: str, video_root_env: str):
    def doc_to_visual(doc):
        root = os.environ.get(video_root_env, os.environ.get("VIDEO_EVAL_ROOT", ""))
        path = doc[video_key]
        if isinstance(path, str) and root and not os.path.isabs(path):
            path = os.path.join(root, path)
        return [path]

    return doc_to_visual


# --------------------------------------------------------------------------
# mvbench (mvbench_think/utils.py): candidates list, answer is option text.
# 20 subtasks, each with its own dataset folder (DATA_LIST, utils.py:19-40)
# and an answered-only accuracy aggregation (utils.py:186-200).
# --------------------------------------------------------------------------

MVBENCH_DATA_LIST = {
    "object_interaction": "star/Charades_segment",
    "action_sequence": "star/Charades_segment",
    "action_prediction": "star/Charades_segment",
    "action_localization": "sta/sta_video_segment",
    "moving_count": "clevrer/video_validation",
    "fine_grained_pose": "nturgbd_convert",
    "character_order": "perception/videos",
    "object_shuffle": "perception/videos",
    "egocentric_navigation": "vlnqa",
    "moving_direction": "clevrer/video_validation",
    "episodic_reasoning": "tvqa/video_fps3_hq_segment",
    "fine_grained_action": "Moments_in_Time_Raw/videos",
    "scene_transition": "scene_qa/video",
    "state_change": "perception/videos",
    "moving_attribute": "clevrer/video_validation",
    "action_antonym": "ssv2_video_mp4",
    "unexpected_action": "FunQA_test/test",
    "counterfactual_inference": "clevrer/video_validation",
    "object_existence": "clevrer/video_validation",
    "action_count": "perception/videos",
}


def mvbench_doc_to_visual(doc, sub_task: str | None = None):
    """Resolve doc['video'] inside the subtask's dataset folder under the
    mvbench root, with the reference's clevrer/star 'data0613' alternative
    (mvbench_think/utils.py:57-72). Root comes from MVBENCH_VIDEO_ROOT."""
    root = os.environ.get("MVBENCH_VIDEO_ROOT",
                          os.environ.get("VIDEO_EVAL_ROOT", ""))
    rel = doc["video"]
    if not isinstance(rel, str):
        return [rel]          # in-memory frames (tests)
    if os.path.isabs(rel) or sub_task is None:
        path = rel if os.path.isabs(rel) else os.path.join(root, rel)
        return [path]
    folder = MVBENCH_DATA_LIST[sub_task]
    path = os.path.join(root, folder, rel)
    if not os.path.exists(path) and folder.split("/")[0] in ("clevrer", "star"):
        alt = os.path.join(root, "data0613", folder, rel)
        if os.path.exists(alt):
            path = alt
    return [path]


def mvbench_doc_to_text(doc):
    opts = letter_options_prompt(doc["candidates"], paren=True)
    return "Question:" + doc["question"] + "\nOption:\n" + opts


def mvbench_process_results(doc, results):
    pred = extract_answer(results[0])
    letters = "ABCDEFGHIJ"
    gt_letter = letters[doc["candidates"].index(doc["answer"])]
    score = mcq_acc(f"{gt_letter}. {doc['answer']}", pred)
    return {"accuracy": score,
            "mvbench_accuracy": {"pred_answer": pred,
                                 "gt_answer": gt_letter, "score": score}}


def mvbench_aggregate(results):
    """100 * correct / answered, counting only non-empty predictions
    (mvbench_think/utils.py:186-200)."""
    answered = [r for r in results if r["pred_answer"] != ""]
    return (100.0 * sum(r["score"] for r in answered) / len(answered)
            if answered else 0.0)


def _mcq_letter_task(name: str, doc_to_text, answer_key: str = "answer",
                     video_key: str = "video"):
    def process_results(doc, results):
        pred = extract_answer(results[0])
        return {"accuracy": mcq_acc(doc[answer_key], pred)}

    return dict(doc_to_text=doc_to_text, process_results=process_results,
                doc_to_target=lambda d: d[answer_key],
                doc_to_visual=_video_resolver(video_key, f"{name.upper()}_VIDEO_ROOT"))


# --------------------------------------------------------------------------
# videomme / videomathqa / minerva style: options are pre-lettered strings
# --------------------------------------------------------------------------

VIDEOMME_OPTION_PROMPT = (
    "Select the best answer to the following multiple-choice question based "
    "on the video and the subtitles. Respond with only the letter (A, B, C, "
    "or D) of the correct option.")

_SUBTITLE_FONT_RE = None  # compiled lazily


def videomme_doc_to_text(doc):
    """videomme_think/utils.py:151-158: option prompt + question + raw
    option strings. The harness appends post_prompt (think prompt, or
    'The best answer is:' in plain mode)."""
    return (VIDEOMME_OPTION_PROMPT + "\n" + doc["question"] + "\n"
            + "\n".join(doc["options"]) + "\n")


def videomme_subtitle_text(doc) -> str:
    """Subtitle context from EXPLICIT doc fields (no env side channels):
    doc['subtitle'] (raw text) or doc['subtitle_path'] (.srt file). The
    reference extracts the <font color="white" size=".72c"> payload from
    Video-MME's styled srt files (videomme_think/utils.py:174-222, with
    frame_num=-1 'all subtitles' behavior); plain srt text passes through."""
    import re as _re

    raw = doc.get("subtitle")
    if raw is None and doc.get("subtitle_path"):
        try:
            raw = open(doc["subtitle_path"], encoding="utf-8").read()
        except OSError:
            raw = None
    if not raw:
        return "No subtitles available"
    pattern = r'<font color="white" size=".72c">(.*?)</font>'
    matches = _re.findall(pattern, raw)
    if matches:
        return "\n".join(matches)
    # plain srt: keep the text lines (drop indices and timecode lines)
    lines = []
    for section in raw.split("\n\n"):
        ls = [l for l in section.strip().split("\n") if l.strip()]
        if len(ls) >= 3:
            lines.append(" ".join(ls[2:]))
    return "\n".join(lines) if lines else raw.strip()


def videomme_subtitle_doc_to_text(doc):
    """videomme_w_subtitle (utils.py:174-229): subtitles block + the same
    option prompt. 'The best answer is:' rides post_prompt."""
    return ("This video's subtitles are listed below: \n"
            + videomme_subtitle_text(doc) + "\n"
            + VIDEOMME_OPTION_PROMPT + "\n" + doc["question"] + "\n"
            + "\n".join(doc["options"]) + "\n")


def videomme_process_results(doc, results):
    """utils.py:262-280: letter via extract_characters_regex; carries the
    duration/domain/sub_category/task_type bucket fields."""
    pred = extract_characters_regex(extract_answer(results[0]))
    data = {"question_id": doc.get("question_id"),
            "duration": doc.get("duration"),
            "category": doc.get("domain"),
            "sub_category": doc.get("sub_category"),
            "task_category": doc.get("task_type"),
            "pred_answer": pred, "answer": doc["answer"]}
    return {"accuracy": 1.0 if pred == doc["answer"] else 0.0,
            "videomme_perception_score": data}


def videomme_aggregate(results):
    """Overall score: 100 * correct / answered across all buckets
    (utils.py:283-330 — every result counts as answered)."""
    n = len(results)
    return (100.0 * sum(r["pred_answer"] == r["answer"] for r in results) / n
            if n else 0.0)


def _abcde_head(options):
    if len(options) == 2:
        return ("Select the best answer to the following multiple-choice "
                "question based on the video. Respond with the letter (A or B) "
                "of the correct option.")
    return ("Select the best answer to the following multiple-choice question "
            "based on the video. Respond with the letter (A, B, C, D or E) of "
            "the correct option.")


def videomathqa_doc_to_text(doc):
    return (_abcde_head(doc["options"]) + "\n" + doc["question"] + "\n"
            + "\n".join(doc["options"]) + "\n")


# --------------------------------------------------------------------------
# minerva (minverva_think/utils.py): videoID + pre-lettered options + letter
# answer, buckets by (length, category); overall = correct/answered.
# --------------------------------------------------------------------------

def minerva_doc_to_visual(doc):
    root = os.environ.get("MINERVA_VIDEO_ROOT",
                          os.environ.get("VIDEO_EVAL_ROOT", ""))
    vid = doc["videoID"]
    if not isinstance(vid, str):
        return [vid]
    base = os.path.join(root, "videos", vid + ".mp4")
    for cand in (base, base.replace("mp4", "MP4"), base.replace("mp4", "mkv"),
                 base.replace("mp4", "webm")):
        if os.path.exists(cand):
            return [cand]
    return [base]


def minerva_doc_to_text(doc):
    """utils.py:91-103: 2-option vs 5-option head + raw option strings;
    post_prompt appended by the harness ('The best answer is:' plain)."""
    return (_abcde_head(doc["options"]) + "\n" + doc["question"] + "\n"
            + "\n".join(doc["options"]) + "\n")


def minerva_process_results(doc, results):
    """utils.py:204-219: letter via extract_characters_regex; carries
    (duration=length, category) for the bucket aggregation."""
    pred = extract_characters_regex(extract_answer(results[0]))
    data = {"question_id": doc.get("question_id"),
            "duration": doc.get("length"),
            "category": doc.get("category"),
            "pred_answer": pred, "answer": doc["answer"]}
    return {"accuracy": 1.0 if pred == doc["answer"] else 0.0,
            "minerva_perception_score": data}


def minerva_aggregate(results):
    """utils.py:222-272 tail: overall 100 * correct / answered."""
    n = len(results)
    return (100.0 * sum(r["pred_answer"] == r["answer"] for r in results) / n
            if n else 0.0)


# --------------------------------------------------------------------------
# scivideobench (scivideobench_think/utils.py): video_id -> jove_<id>.mp4,
# options dict or list, letter answer, per-qtype/category buckets.
# --------------------------------------------------------------------------

SCIVIDEOBENCH_LETTERS = ["A", "B", "C", "D", "E", "F", "G", "H", "I", "J"]


def scivideobench_doc_to_visual(doc):
    root = os.environ.get("SCIVIDEOBENCH_VIDEO_ROOT",
                          os.environ.get("VIDEO_EVAL_ROOT", ""))
    vid = doc["video_id"]
    if not isinstance(vid, (str, int)):
        return [vid]
    base = os.path.join(root, "videos", f"jove_{vid}.mp4")
    for cand in (base, base.replace("mp4", "MP4"), base.replace("mp4", "mkv")):
        if os.path.exists(cand):
            return [cand]
    return [base]


def scivideobench_format_options(opts) -> str:
    """utils.py:77-86: dict keys in A..Z order, or list auto-lettered."""
    if isinstance(opts, dict):
        return "\n".join(f"{k}. {opts[k]}" for k in sorted(opts.keys()))
    if isinstance(opts, list):
        return "\n".join(f"{SCIVIDEOBENCH_LETTERS[i]}. {o}"
                         for i, o in enumerate(opts))
    raise TypeError(f"Unsupported options type: {type(opts)}")


def scivideobench_doc_to_text(doc):
    return f"{doc['question']}\n{scivideobench_format_options(doc['options'])}"


def scivideobench_extract_letter(s: str) -> str:
    """utils.py:111-136 extract_answer_letter: strip known prefixes, then
    first standalone A-J letter."""
    import re as _re

    s = s.strip()
    for prefix in ("The answer is", "The correct answer is",
                   "The best answer is", "Answer:", "Option:",
                   "### Final Answer:\n$$\\boxed", "the final answer is"):
        s = s.replace(prefix, "")
    m = _re.search(r"\b([A-J])\b", s.strip().upper())
    return m.group(1) if m else ""


def scivideobench_process_results(doc, results):
    """utils.py:139-160 — including the reference's random-guess fallback
    for unparsable predictions."""
    import random as _random

    pred = scivideobench_extract_letter(extract_answer(results[0]))
    if not pred:
        pred = _random.choice(SCIVIDEOBENCH_LETTERS)
    gold = str(doc["answer"]).strip()
    data = {"id": doc.get("video_id"),
            "question_type": doc.get("question_type", "UNKNOWN"),
            "category": doc.get("category", "UNKNOWN"),
            "pred_answer": pred, "answer": gold,
            "correct": pred == gold}
    return {"accuracy": 1.0 if pred == gold else 0.0,
            "scivideobench_acc": data}


def scivideobench_aggregate(results):
    """utils.py:163-200 tail: overall 100 * correct / total."""
    n = len(results)
    return (100.0 * sum(bool(r["correct"]) for r in results) / n if n else 0.0)


# scivideobench's think post-prompt keeps its own 'Answer with the option's
# letter' lead-in before the standard think text (scivideobench_think yaml)
SCIVIDEOBENCH_THINK_POST = (
    "\nAnswer with the option's letter from the given choices directly."
    + THINK_POST_PROMPT)


def longvideobench_doc_to_text(doc):
    """longvideobench_think/utils.py:115-123: option0..4 fields, 'N/A' =
    absent, lettered A..E."""
    candidates = [doc.get(f"option{i}") for i in range(5)
                  if doc.get(f"option{i}") not in (None, "N/A")]
    lines = "\n".join(f"{chr(ord('A') + i)}. {c}" for i, c in enumerate(candidates))
    return doc["question"] + "\n" + lines


def lvb_parse_multi_choice(response: str, all_choices: list[str]) -> str:
    """utils.py:204-230: strip answer prefixes, first A-E letter; random
    choice when unparsable (the LongVideoBench authors' protocol)."""
    import random as _random
    import re as _re

    s = response.strip()
    for prefix in ("The best answer is", "The correct answer is",
                   "The answer is", "The answer", "The best option is",
                   "The correct option is", "Best answer:", "Best option:"):
        s = s.replace(prefix, "")
    if len(s.split()) > 10 and not _re.search("[ABCDE]", s):
        return _random.choice(all_choices)
    m = _re.search(r"[ABCDE]", s)
    return m[0] if m else _random.choice(all_choices)


def longvideobench_process_results(doc, results):
    """utils.py:280-299: gold = chr(A + correct_choice); carries
    duration_group/question_category buckets."""
    pred = extract_answer(results[0])
    all_choices = []
    for i in range(5):
        if doc.get(f"option{i}") in (None, "N/A"):
            break
        all_choices.append(chr(ord("A") + i))
    parsed = lvb_parse_multi_choice(pred, all_choices or ["A"])
    gold = chr(ord("A") + int(doc["correct_choice"]))
    data = {"id": doc.get("id"),
            "duration_group": doc.get("duration_group"),
            "question_category": doc.get("question_category"),
            "answer": gold, "parsed_pred": parsed}
    return {"accuracy": 1.0 if parsed == gold else 0.0, "lvb_acc": data}


def longvideobench_aggregate(results):
    n = len(results)
    return (100.0 * sum(r["parsed_pred"] == r["answer"] for r in results) / n
            if n else 0.0)


def mmvu_doc_to_text(doc):
    if doc.get("question_type") == "multiple-choice":
        ch = doc["choices"]
        return (f"Question: {doc['question']}\nA. {ch['A']}\nB. {ch['B']}\n"
                f"C. {ch['C']}\nD. {ch['D']}\nE. {ch['E']}\n")
    return f"Question: {doc['question']}\n"


# --------------------------------------------------------------------------
# vsibench: dual MCA (exact match on first word) / NA (mean relative accuracy)
# --------------------------------------------------------------------------

VSI_MCA_TYPES = {
    "object_rel_direction_easy", "object_rel_direction_medium",
    "object_rel_direction_hard", "object_rel_distance", "route_planning",
    "obj_appearance_order",
}
VSI_NA_TYPES = {
    "object_abs_distance", "object_counting", "object_size_estimation",
    "room_size_estimation",
}


def vsibench_doc_to_text(doc):
    pre = "These are frames of a video."
    q = doc["question"]
    if doc["question_type"] in VSI_NA_TYPES:
        return (pre + "\n" + q + "\n"
                + "Please answer the question using a single word or phrase.")
    options = "Options:\n" + "\n".join(doc["options"])
    return "\n".join([pre, q, options,
                      "Answer with the option's letter from the given choices directly."])


def vsibench_process_results(doc, results):
    pred = fuzzy_first_word(extract_answer(results[0]))
    qt = doc["question_type"]
    if qt in VSI_MCA_TYPES:
        score = 1.0 if pred.lower() == str(doc["ground_truth"]).lower() else 0.0
    elif qt in VSI_NA_TYPES:
        p, t = to_float(pred), to_float(doc["ground_truth"])
        score = mean_relative_accuracy(p, t) if (p is not None and t is not None
                                                and t != 0) else 0.0
    else:
        raise ValueError(f"Unknown question type: {qt}")
    return {"accuracy": score, "vsibench_score": {"question_type": qt,
                                                  "score": score}}


def vsibench_aggregate(scores):
    """Mean of per-question-type means (reference aggregates per type then
    averages; vsibench_think/utils.py:131-160)."""
    by_type: dict[str, list[float]] = {}
    for s in scores:
        by_type.setdefault(s["question_type"], []).append(s["score"])
    per_type = [sum(v) / len(v) for v in by_type.values()]
    return 100.0 * sum(per_type) / max(len(per_type), 1)


# --------------------------------------------------------------------------
# registration
# --------------------------------------------------------------------------

def _acc_metric():
    return [MetricSpec("accuracy", mean)]


def build_task(name: str, think: bool, docs=None, dataset_path=None,
               sub_task: str | None = None) -> Task:
    post = THINK_POST_PROMPT if think else ""
    task_name = f"{name}_think" if think else name

    if name == "mvbench":
        if sub_task is not None:
            task_name = (f"mvbench_{sub_task}_think" if think
                         else f"mvbench_{sub_task}")
        cfg = TaskConfig(
            task=task_name,
            doc_to_text=mvbench_doc_to_text,
            doc_to_visual=partial(mvbench_doc_to_visual, sub_task=sub_task),
            doc_to_target=lambda d: d["answer"],
            process_results=mvbench_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("mvbench_accuracy", mvbench_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path, dataset_name=sub_task)
    elif name == "vsibench":
        def vsibench_doc_to_visual(doc):
            # vsibench_think/utils.py:49: <root>/<dataset>/<scene_name>.mp4
            if "scene_name" in doc:
                root = os.environ.get("VSIBENCH_VIDEO_ROOT",
                                      os.environ.get("VIDEO_EVAL_ROOT", ""))
                return [os.path.join(root, doc["dataset"],
                                     doc["scene_name"] + ".mp4")]
            return _video_resolver("video", "VSIBENCH_VIDEO_ROOT")(doc)

        cfg = TaskConfig(
            task=task_name, doc_to_text=vsibench_doc_to_text,
            doc_to_visual=vsibench_doc_to_visual,
            doc_to_target=lambda d: str(d["ground_truth"]),
            process_results=vsibench_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("vsibench_score", vsibench_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "mlvu":
        # per-task_type accuracy averaged across types (mlvu_think/utils.py:
        # 132-160); letters via extract_characters_regex
        def mlvu_process_results(doc, results):
            pred = extract_characters_regex(extract_answer(results[0]))
            correct = 1.0 if pred == extract_characters_regex(
                str(doc["answer"])) else 0.0
            return {"accuracy": correct,
                    "mlvu_score": {"task_type": doc.get("task_type", "all"),
                                   "correct": correct}}

        def mlvu_aggregate(scores):
            by_type: dict[str, list[float]] = {}
            for s in scores:
                by_type.setdefault(s["task_type"], []).append(s["correct"])
            per = [sum(v) / len(v) for v in by_type.values()]
            return 100.0 * sum(per) / max(len(per), 1)

        def mlvu_doc_to_visual(doc):
            # mlvu_think/utils.py:46: the video field is 'video_name'
            key = "video_name" if "video_name" in doc else "video"
            return _video_resolver(key, "MLVU_VIDEO_ROOT")(doc)

        cfg = TaskConfig(
            task=task_name, doc_to_text=lambda d: d["question"],
            doc_to_visual=mlvu_doc_to_visual,
            doc_to_target=lambda d: str(d["answer"]),
            process_results=mlvu_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("mlvu_score", mlvu_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "videommmu":
        # MCQ letter parse against options; open-ended via normalized
        # containment (videommmu_think/utils.py:154-165 surface)
        def videommmu_doc_to_text(doc):
            q = doc["question"]
            if doc.get("question_type") == "multiple-choice" and doc.get("options"):
                opts = doc["options"]
                if isinstance(opts, dict):
                    lines = "\n".join(f"{k}. {v}" for k, v in sorted(opts.items()))
                else:
                    lines = "\n".join(
                        f"{chr(ord('A') + i)}. {o}" for i, o in enumerate(opts))
                q += "\n" + lines
            return q

        def videommmu_process_results(doc, results):
            pred = extract_answer(results[0])
            gt = str(doc["answer"])
            if doc.get("question_type") == "multiple-choice":
                score = 1.0 if extract_characters_regex(pred) == \
                    extract_characters_regex(gt) else 0.0
            else:
                p = pred.strip().lower().rstrip(".")
                g = gt.strip().lower()
                pf, gf = to_float(p), to_float(g)
                if pf is not None and gf is not None:
                    score = 1.0 if abs(pf - gf) < 1e-6 else 0.0
                else:
                    score = 1.0 if (g and g in p) else 0.0
            return {"accuracy": score}

        cfg = TaskConfig(
            task=task_name, doc_to_text=videommmu_doc_to_text,
            doc_to_visual=_video_resolver("video", "VIDEOMMMU_VIDEO_ROOT"),
            doc_to_target=lambda d: str(d["answer"]),
            process_results=videommmu_process_results, metrics=_acc_metric(),
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name in ("videomme", "videomme_w_subtitle"):
        # plain-mode post prompt is the reference's llava-style default
        # (videomme_think/utils.py:156, minerva utils.py:100)
        if not think:
            post = "The best answer is:"
        cfg = TaskConfig(
            task=task_name,
            doc_to_text=(videomme_subtitle_doc_to_text
                         if name.endswith("subtitle") else videomme_doc_to_text),
            doc_to_visual=_video_resolver("videoID", "VIDEOMME_VIDEO_ROOT"),
            doc_to_target=lambda d: str(d["answer"]),
            process_results=videomme_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("videomme_perception_score",
                                videomme_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "minerva":
        if not think:
            post = "The best answer is:"
        cfg = TaskConfig(
            task=task_name, doc_to_text=minerva_doc_to_text,
            doc_to_visual=minerva_doc_to_visual,
            doc_to_target=lambda d: str(d["answer"]),
            process_results=minerva_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("minerva_perception_score",
                                minerva_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "scivideobench":
        post = SCIVIDEOBENCH_THINK_POST if think else (
            "\nAnswer with the option's letter from the given choices "
            "directly.")
        cfg = TaskConfig(
            task=task_name, doc_to_text=scivideobench_doc_to_text,
            doc_to_visual=scivideobench_doc_to_visual,
            doc_to_target=lambda d: str(d["answer"]),
            process_results=scivideobench_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("scivideobench_acc", scivideobench_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "videomathqa":
        # videomathqa_think/utils.py:230-243: letter via
        # extract_characters_regex, buckets (length, category)
        if not think:
            post = "The best answer is:"

        def videomathqa_process_results(doc, results):
            pred = extract_characters_regex(extract_answer(results[0]))
            data = {"question_id": doc.get("question_id"),
                    "duration": doc.get("length"),
                    "category": doc.get("category"),
                    "pred_answer": pred, "answer": doc["answer"]}
            return {"accuracy": 1.0 if pred == doc["answer"] else 0.0,
                    "videomathqa_perception_score": data}

        cfg = TaskConfig(
            task=task_name, doc_to_text=videomathqa_doc_to_text,
            doc_to_visual=_video_resolver("videoID", "VIDEOMATHQA_VIDEO_ROOT"),
            doc_to_target=lambda d: str(d["answer"]),
            process_results=videomathqa_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("videomathqa_perception_score",
                                minerva_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "longvideobench":
        cfg = TaskConfig(
            task=task_name, doc_to_text=longvideobench_doc_to_text,
            doc_to_visual=_video_resolver("video_path",
                                          "LONGVIDEOBENCH_VIDEO_ROOT"),
            doc_to_target=lambda d: chr(ord("A") + int(d["correct_choice"])),
            process_results=longvideobench_process_results,
            metrics=[MetricSpec("accuracy", mean),
                     MetricSpec("lvb_acc", longvideobench_aggregate)],
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    elif name == "mmvu":
        # mmvu_think/utils.py:247-264: MCQ letter compare against the
        # 'answer' letter; open-ended normalized match (the reference's GPT
        # judge for open-ended is an external dependency)
        def mmvu_process_results(doc, results):
            pred = extract_answer(results[0])
            if doc.get("question_type") == "multiple-choice":
                letter = extract_characters_regex(pred)
                score = 1.0 if letter == doc["answer"] else 0.0
            else:
                p = pred.strip().lower().rstrip(".")
                g = str(doc["answer"]).strip().lower()
                score = 1.0 if (g and (p == g or g in p)) else 0.0
            return {"accuracy": score}

        cfg = TaskConfig(
            task=task_name, doc_to_text=mmvu_doc_to_text,
            doc_to_visual=_video_resolver("video_path", "MMVU_VIDEO_ROOT"),
            doc_to_target=lambda d: str(d["answer"]),
            process_results=mmvu_process_results, metrics=_acc_metric(),
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    else:  # tempcompass flat alias (task-type variants live in tempcompass.py)
        def process_results(doc, results):
            pred = extract_answer(results[0])
            gt = str(doc.get("answer", doc.get("answer_text", "")))
            return {"accuracy": mcq_acc(gt, pred)}

        cfg = TaskConfig(
            task=task_name, doc_to_text=lambda d: d["question"],
            doc_to_visual=_video_resolver("video",
                                          f"{name.upper()}_VIDEO_ROOT"),
            doc_to_target=lambda d: str(d.get("answer", d.get("answer_text", ""))),
            process_results=process_results, metrics=_acc_metric(),
            generation_kwargs=dict(MCQ_GEN_KWARGS), post_prompt=post,
            dataset_path=dataset_path)
    return Task(cfg, docs=docs)


BENCHMARKS = ["mvbench", "videomme", "videomme_w_subtitle", "tempcompass",
              "mlvu", "longvideobench", "videomathqa", "videommmu", "mmvu",
              "vsibench", "minerva", "scivideobench"]

for _name in BENCHMARKS:
    register_task(_name, partial(build_task, _name, False))
    register_task(f"{_name}_think", partial(build_task, _name, True))

# mvbench's 20 per-subtask tasks (reference mvbench.yaml group members);
# mvbench_subtasks() builds the whole group for evaluate().
for _sub in MVBENCH_DATA_LIST:
    register_task(f"mvbench_{_sub}",
                  partial(build_task, "mvbench", False, sub_task=_sub))
    register_task(f"mvbench_{_sub}_think",
                  partial(build_task, "mvbench", True, sub_task=_sub))


def mvbench_subtasks(think: bool = True, docs_by_subtask: dict | None = None,
                     dataset_path: str | None = None) -> list[Task]:
    """The reference's mvbench group (mvbench.yaml): one task per DATA_LIST
    subtask. docs_by_subtask maps subtask -> docs for offline runs."""
    out = []
    for sub in MVBENCH_DATA_LIST:
        docs = (docs_by_subtask or {}).get(sub)
        out.append(build_task("mvbench", think, docs=docs,
                              dataset_path=dataset_path, sub_task=sub))
    return out
