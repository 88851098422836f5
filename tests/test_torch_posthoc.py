"""The post-hoc metrics of the PyTorch port (TAC, VAS, the post-processing
dispatcher and the VSIBench normalisation) against the JAX package.

The three modules are jax-free copies: every function and class must be
the original's source, line for line, and every constant equal. Then both
packages run over one fixture predictions tree (mvbench shards in pooled
directory mode, vsibench NA / MCA rows, mmvu open and multiple-choice rows,
videomme) with the same judge, whose answer depends only on the request,
and every file they write, every summary and every plan must be equal
(exact: the metrics are host arithmetic on the same strings).
"""

import hashlib
import importlib
import inspect
import json

import pytest

from video_r2_tpu.evalharness import postprocess as jpost
from video_r2_tpu.evalharness import tac as jtac
from video_r2_tpu.evalharness import vas as jvas
from video_r2_tpu_torch.evalharness import postprocess, tac, vas

MODULES = {"tac": (tac, jtac), "vas": (vas, jvas), "postprocess": (postprocess, jpost)}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_posthoc_copies_match(name):
    ours, ref = MODULES[name]
    defs = [n for n, v in vars(ref).items()
            if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == ref.__name__]
    assert len(defs) >= 5
    for n in defs:
        assert inspect.getsource(getattr(ours, n)) == inspect.getsource(getattr(ref, n)), n
    consts = [n for n in vars(ref) if n.isupper() or n.startswith("_") and n[1:].isupper()]
    for n in consts:
        assert getattr(ours, n) == getattr(ref, n), n
    # the judge prompts are metric data
    if name == "vas":
        assert ours.SYSTEM_PROMPT == ref.SYSTEM_PROMPT and len(ours.SYSTEM_PROMPT) > 2500


class KeyedJudge:
    """Answers by a hash of the request, so that the answer does not depend
    on call order or thread: letters (and UNKNOWN) for the MCQ prompts,
    numbers for the numeric ones, scores (and text that is no JSON, which
    VAS retries, then scores 0) for the VAS rubric."""

    def __init__(self):
        self.calls = []

    def chat(self, system: str, user: str) -> str:
        self.calls.append((system, user))
        h = int(hashlib.sha256((system + user).encode()).hexdigest(), 16)
        if system == jvas.SYSTEM_PROMPT:
            return ['{"score": 7, "rationale": "cites colours"}', "no json here",
                    '{"score": 3, "rationale": "generic"}'][h % 3]
        if system == jtac.NUMERIC_EXTRACT_SYSTEM:
            return ["4", "3.7", "about 12"][h % 3]
        return ["A", "B", "C", "UNKNOWN", "19.62"][h % 5]


def _write(path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))


def _predictions(root):
    """A predictions tree that takes every mode of the dispatcher."""
    think = "<think>{t}</think><answer>{a}</answer>"
    for i, shard in enumerate(("action_count", "scene_transition")):
        _write(root / f"samples_mvbench_{shard}.jsonl", [
            {"doc_id": j, "accuracy": j % 2, "input": f"Q{j}",
             "filtered_resps": [think.format(t=f"so {'AB'[j % 2]}", a="AB"[j % 2])],
             "doc": {"candidates": ["jump", "run", "sit"], "answer": "run"}}
            for j in range(i + 2)])
    _write(root / "samples_vsibench_think.jsonl", [
        {"doc_id": 0, "accuracy": 0.9, "input": "how far",
         "filtered_resps": [think.format(t="roughly 3.7m", a="3.7 meters")],
         "doc": {"question_type": "object_abs_distance", "ground_truth": 4.0}},
        {"doc_id": 1, "accuracy": 1, "input": "which way",
         "filtered_resps": [think.format(t="so B", a="B")],
         "doc": {"question_type": "route_planning", "answer": "B",
                 "options": ["A. left", "B. right"]}},
        {"doc_id": 2, "accuracy": 0.0, "input": "how many",
         "resps": [["there are seven chairs"]],
         "doc": {"question_type": "object_counting", "ground_truth": "7"}}])
    _write(root / "samples_mmvu_think.jsonl", [
        {"doc_id": 0, "accuracy": 1, "input": "energy?",
         "filtered_resps": [think.format(t="compute 9.81*2", a="19.62 J")],
         "doc": {"question_type": "open-ended", "answer": "19.62"}},
        {"doc_id": 1, "accuracy": 0, "input": "pick",
         "filtered_resps": [think.format(t="C is correct", a="C")],
         "doc": {"question_type": "multiple-choice", "answer": "A",
                 "choices": {"A": "x", "B": "y", "C": "z"}}}])
    _write(root / "samples_videomme_think.jsonl", [
        {"doc_id": 0, "accuracy": 1, "input": "what",
         "filtered_resps": [think.format(t="the dog, so B", a="B")],
         "doc": {"options": ["A. cat", "B. dog"], "answer": "B"}},
        {"doc_id": 1, "accuracy": 0, "input": "what", "filtered_resps": ["no tags"],
         "doc": {"options": ["A. cat", "B. dog"], "answer": "A"}}])


def _tree(root):
    """Every file under root: relative path -> parsed content."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            text = p.read_text()
            out[str(p.relative_to(root))] = (
                [json.loads(line) for line in text.splitlines() if line.strip()]
                if p.suffix == ".jsonl" else json.loads(text))
    return out


def _run(pkg, tmp):
    preds = tmp / "preds"
    _predictions(preds)
    judge = KeyedJudge()
    tac_out = pkg.run_all_tac(preds, judge, tmp / "tac")
    plan = pkg.run_all_vas(preds, judge, tmp / "vas", dry_run=True)
    vas_out = pkg.run_all_vas(preds, judge, tmp / "vas")
    again = pkg.run_all_vas(preds, judge, tmp / "vas")        # skip-if-done
    rows = [json.loads(line) for line in open(preds / "samples_vsibench_think.jsonl")]
    vsi = ([pkg.postprocess_vsibench_row(r) for r in rows]
           + [pkg.postprocess_vsibench_row(r, judge=judge) for r in rows])
    summaries = (pkg.summarize_tac_tree(tmp / "tac"), pkg.summarize_vas_tree(tmp / "vas"))
    text = json.dumps([tac_out, plan, vas_out, again, vsi, summaries], sort_keys=True,
                      default=str)
    return (json.loads(text.replace(str(tmp), "<root>")),
            _tree(tmp / "tac"), _tree(tmp / "vas"), judge.calls)


def test_posthoc_outputs_match_jax(tmp_path):
    """run_all_tac, run_all_vas (its plan, a fresh run with the retry pass,
    a skip-if-done rerun), the vsibench rows with and without a judge and
    both tree summaries: equal to the JAX package's, file for file."""
    ours = _run(postprocess, tmp_path / "port")
    ref = _run(jpost, tmp_path / "jax")
    assert ours[0] == ref[0]
    assert ours[1] == ref[1] and ours[2] == ref[2]
    assert sorted(ours[3]) == sorted(ref[3])
    tac_out, plan, vas_out = ours[0][:3]
    # every mode and both pooled benchmarks took part
    assert tac_out["mvbench"]["__directory__"]["num_samples"] == 5
    assert tac_out["vsibench"]["samples_vsibench_think"]["modes"] == {"mra": 2, "mcq": 1}
    assert set(tac_out["mmvu"]["samples_mmvu_think"]["modes"]) == {"open", "mcq"}
    assert plan["mvbench"]["__directory__"]["dry_run"] and not any(
        "error" in v for v in tac_out.values())
    dist = vas_out["mvbench"]["__directory__"]["score_distribution"]
    assert sum(dist.values()) == 5
    assert "consistency_score" in json.dumps(ours[0][5])


def test_posthoc_module_imports():
    """The apps that drive them import the port's copies."""
    app = importlib.import_module("video_r2_tpu_torch.apps.postprocess")
    assert app.run_all_tac is postprocess.run_all_tac
    assert app.run_all_vas is postprocess.run_all_vas


# ---------------------------------------------------------------------------
# the quantitative VAS: models/attention_tap.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tap_models():
    import jax
    import numpy as np

    from video_r2_tpu.models.config import tiny_test_config as j_tiny
    from video_r2_tpu.models.loader import init_params as j_init
    from video_r2_tpu_torch.models.config import tiny_test_config
    from video_r2_tpu_torch.models.convert import load_jax_params
    from video_r2_tpu_torch.models.loader import init_params

    jparams = j_init(j_tiny(), seed=7)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


@pytest.mark.parametrize("case", ["patches", "window_chunks", "embeds_flash"])
def test_attention_tap_matches_jax(tap_models, case):
    """attention_to_video_scores equals the JAX function on the tiny config
    (two rows, the second right-padded): over video embeds with a trailing
    window of 5 rows and key chunks of 7 (shorter than S = 23, a tail
    chunk), over video embeds with the decoder on "flash" (the flash
    kernel's plain version here), and over ViT patches. Tolerance 1e-5
    absolute on the embeds cases: a mass in [0, 1] from float32 softmaxes
    summed in other orders; 5e-4 over patches, where each package runs its
    own ViT tower first (tests/test_torch_model.py holds the two towers
    within 1e-4 of the output scale)."""
    import numpy as np

    from video_r2_tpu.models.attention_tap import attention_to_video_scores as j_tap
    from video_r2_tpu.models.config import tiny_test_config as j_tiny
    from video_r2_tpu.models.vision import plan_vision_layout as j_plan
    from video_r2_tpu_torch.models.attention_tap import attention_to_video_scores
    from video_r2_tpu_torch.models.mrope import get_rope_index
    from video_r2_tpu_torch.models.vision import plan_vision_layout

    jparams, model = tap_models
    cfg = model.cfg
    rng = np.random.default_rng(3)
    grid = (2, 4, 4)
    n_vid = 8
    row = ([5, 6, cfg.vision_start_token_id] + [cfg.video_token_id] * n_vid
           + [cfg.vision_end_token_id] + list(rng.integers(7, 250, size=11)))
    S = len(row)
    ids = np.asarray([row, row[:-3] + [cfg.pad_token_id] * 3], np.int64)
    amask = np.ones_like(ids)
    amask[1, -3:] = 0
    qmask = np.zeros_like(ids)
    qmask[0, -5:] = 1
    qmask[1, -8:-3] = 1
    grids = np.asarray([grid, grid])
    pos, _ = get_rope_index(ids, cfg, video_grid_thw=grids,
                            second_per_grid_ts=np.asarray([1.0, 1.0]), attention_mask=amask)
    kw = {"window_chunks": dict(completion_window=5, key_chunk=7),
          "patches": {}, "embeds_flash": dict(key_chunk=16)}[case]
    if case != "patches":
        emb = rng.normal(size=(2 * n_vid, cfg.text.hidden_size)).astype(np.float32)
        ours = attention_to_video_scores(model, ids, pos, amask, qmask, video_embeds=emb,
                                         attn_impl="flash" if case == "embeds_flash"
                                         else "xla", **kw)
        ref = j_tap(jparams, j_tiny(), ids, pos, amask, qmask, video_embeds=emb, **kw)
    else:
        patches = rng.normal(size=(64, cfg.vision.patch_input_dim)).astype(np.float32)
        ours = attention_to_video_scores(model, ids, pos, amask, qmask,
                                         video_patches=patches,
                                         video_layout=plan_vision_layout([grid, grid],
                                                                         cfg.vision), **kw)
        ref = j_tap(jparams, j_tiny(), ids, pos, amask, qmask, video_patches=patches,
                    video_layout=j_plan([grid, grid], j_tiny().vision), **kw)
    assert ours.shape == (2,) and S == 23
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-4 if case == "patches" else 1e-5)
    assert ((ours >= 0) & (ours <= 1)).all() and float(ours.min()) > 0
