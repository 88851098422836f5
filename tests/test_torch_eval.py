"""The port's eval path against the JAX package's, on the CPU.

The harness modules the port copies (api, runner, regression, model_api's
fakes, tasks) must be the originals' source, and each fixture benchmark's
text, per-sample rows and aggregates equal under StaticModel. The engine
backend runs the tiny config in float32 with the JAX weights carried across
(load_jax_params): greedy responses, per-sample rows and results must be
exactly equal to the JAX EngineModel's in batch and in paged mode, and
loglikelihood within 1e-4 (float32, another summation order). The JAX side
runs its plain ("xla") attention; the port's "auto" runs the plain path on
the CPU.
"""

import dataclasses
import gc
import inspect
import json
import threading
import urllib.request
import weakref
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from video_r2_tpu import config as japp
from video_r2_tpu.apps import demo as jdemo
from video_r2_tpu.evalharness import EngineModel as JEngineModel
from video_r2_tpu.evalharness import StaticModel as JStaticModel
from video_r2_tpu.evalharness import evaluate as j_evaluate
from video_r2_tpu.evalharness import get_task as j_get_task
from video_r2_tpu.evalharness.api import Instance as JInstance
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu_torch import config as app
from video_r2_tpu_torch.apps import common, run_eval
from video_r2_tpu_torch.apps.demo import DemoRunner, make_handler
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.evalharness import EngineModel, StaticModel, evaluate, get_task
from video_r2_tpu_torch.evalharness.api import Instance
from video_r2_tpu_torch.evalharness.engine_backend import EngineBackend
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import load_jax_params
from video_r2_tpu_torch.models.loader import init_params
from tests.test_torch_video import SRT, _write_mp4

FIXTURES = Path(__file__).parent / "fixtures" / "eval_docs"
# the ByteTokenizer with the tiny config's special ids (all below its vocab of 512)
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}
# frames of 56 x 56 that min / max pixels keep; 4 frames of a clip
EVAL_KW = dict(max_num_frames=4, max_pixels=56 * 56, min_pixels=4 * 28 * 28,
               batch_size=2)
NEW_TOKENS = 8
LL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_feature_cache(monkeypatch):
    monkeypatch.delenv("VR2_VIDEO_CACHE", raising=False)
    monkeypatch.delenv("VR2_DECODE_PROCS", raising=False)


@pytest.fixture(scope="module")
def models():
    jparams = j_init(j_tiny(), seed=11)
    model = init_params(tiny_test_config(), seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return jparams, model


def _docs(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [{"video": rng.integers(0, 256, (6 + 2 * i, 56, 56, 3), np.uint8),
             "question": f"What is shown in clip {i}?",
             "candidates": ["a cat", "a dog", "a car"], "answer": "a dog"}
            for i in range(n)]


def _rows(out, task):
    """Per-sample rows without the numpy-valued doc (its str() differs only
    in array repr) and the results without the wall time."""
    rows = [{k: v for k, v in r.items() if k != "doc"} for r in out["samples"][task]]
    res = {k: v for k, v in out["results"][task].items() if k != "time_s"}
    return rows, res


def _both(models, docs, task="mvbench_think", **kw):
    """The same docs through the JAX EngineModel and the port's."""
    jparams, model = models
    tok = ByteTokenizer(SPECIALS)
    outs = []
    for em, ev, gt in ((lambda: JEngineModel(jparams, j_tiny(), tok, **EVAL_KW, **kw),
                        j_evaluate, j_get_task),
                       (lambda: EngineModel(model, tok, **EVAL_KW, **kw), evaluate, get_task)):
        t = gt(task, docs=docs)
        t.config.generation_kwargs["max_new_tokens"] = NEW_TOKENS
        outs.append(ev(em(), [t]))
    return [_rows(o, task) for o in outs]


def test_harness_copies_match():
    """The copied harness modules are the originals' source, definition by
    definition, and the task registries hold the same names."""
    import importlib

    for name in ("api", "runner", "regression", "tasks", "tasks.common",
                 "tasks.benchmarks", "tasks.tempcompass"):
        ours = importlib.import_module(f"video_r2_tpu_torch.evalharness.{name}")
        ref = importlib.import_module(f"video_r2_tpu.evalharness.{name}")
        defs = [n for n, v in vars(ref).items()
                if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == ref.__name__]
        assert defs, name
        for n in defs:
            assert inspect.getsource(getattr(ours, n)) == inspect.getsource(
                getattr(ref, n)), (name, n)
        consts = [n for n, v in vars(ref).items() if n.lstrip("_").isupper()
                  and isinstance(v, (str, int, float, tuple, list, dict))
                  and n != "_REGISTRY"]   # the registry: list_tasks below
        for n in consts:
            assert getattr(ours, n) == getattr(ref, n), (name, n)
    from video_r2_tpu.evalharness import model_api as jmodel_api
    from video_r2_tpu.evalharness import tasks as jtasks
    from video_r2_tpu_torch.evalharness import model_api, tasks

    for n in ("LMM", "FromLogModel", "StaticModel", "uniform_subsample_indices"):
        assert inspect.getsource(getattr(model_api, n)) == inspect.getsource(
            getattr(jmodel_api, n)), n
    assert tasks.list_tasks() == jtasks.list_tasks()
    for n, m in ((10, 4), (7, 7), (100, 9)):
        assert model_api.uniform_subsample_indices(n, m) == \
            jmodel_api.uniform_subsample_indices(n, m)


def _answer(text):
    return f"<think>let me think about it</think><answer>{text}</answer>"


FIXTURE_TASKS = {
    "mvbench_action_count": "mvbench_action_count_think", "videomme": "videomme_think",
    "videomme_w_subtitle": "videomme_w_subtitle_think", "mlvu": "mlvu_think",
    "longvideobench": "longvideobench_think", "videomathqa": "videomathqa_think",
    "videommmu": "videommmu_think", "mmvu": "mmvu_think", "vsibench": "vsibench_think",
    "minerva": "minerva_think", "scivideobench": "scivideobench_think",
    "tempcompass": "tempcompass_think", "tempcompass_complete": "tempcompass_complete_think",
}


def test_every_fixture_has_a_task():
    assert {p.stem for p in FIXTURES.glob("*.jsonl")} == set(FIXTURE_TASKS)


@pytest.mark.parametrize("fixture", sorted(FIXTURE_TASKS))
def test_fixture_task_matches_jax(fixture, tmp_path):
    """doc_to_text (the instances' input), process_results (every per-sample
    row) and the aggregates equal the JAX package's under StaticModel, for
    right, wrong and untagged responses; both write the same samples file."""
    docs = [json.loads(line) for line in open(FIXTURES / f"{fixture}.jsonl")]
    task = FIXTURE_TASKS[fixture]
    resps = [_answer("B"), "A", _answer("4"), "The correct answer is C"]
    ours = evaluate(StaticModel(resps), [get_task(task, docs=docs)],
                    output_dir=tmp_path / "ours")
    ref = j_evaluate(JStaticModel(resps), [j_get_task(task, docs=docs)],
                     output_dir=tmp_path / "ref")
    (o_rows, o_res), (r_rows, r_res) = _rows(ours, task), _rows(ref, task)
    assert o_rows == r_rows
    assert o_res == r_res
    assert ours["configs"] == ref["configs"]
    assert [i.text for i in get_task(task, docs=docs).build_instances()] == [
        i.text for i in j_get_task(task, docs=docs).build_instances()]
    assert ((tmp_path / "ours" / f"samples_{task}.jsonl").read_text()
            == (tmp_path / "ref" / f"samples_{task}.jsonl").read_text())


def test_eval_config_matches_jax():
    """EvalConfig and RunConfig's mesh / weight_quant fields have the JAX
    defaults, and --eval / --run flags parse alike."""
    assert (dataclasses.asdict(app.EvalConfig())
            == dataclasses.asdict(japp.EvalConfig()))
    ours, ref = app.RunConfig(), japp.RunConfig()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    argv = ["--eval.engine_mode", "paged", "--eval.batch_size=4", "--eval.fps", "1.5",
            "--eval.kv_quant", "int8", "--run.weight_quant", "int4", "--eval.decode_steps=2"]
    assert (dataclasses.asdict(app.parse_config(argv).eval)
            == dataclasses.asdict(japp.parse_config(argv).eval))
    assert app.parse_config(argv).run.weight_quant == "int4"


def test_build_model_and_refusals(monkeypatch):
    a = app.AppConfig(run=app.RunConfig(model_preset="tiny-test", weight_quant="in8"))
    with pytest.raises(ValueError, match="weight_quant"):
        common.build_model(a, device="cpu")
    a = app.AppConfig(run=app.RunConfig(model_preset="tiny-test", weight_quant="int8"))
    model = common.build_model(a, device="cpu")
    assert model.model.layers[0].attn.q.kernel_q is not None
    assert model.model.layers[0].attn.q.kernel is None
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        common.build_model(app.AppConfig(run=app.RunConfig(
            model_preset="tiny-test", checkpoint="ckpt")), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        common.build_tokenizer(app.AppConfig(run=app.RunConfig(tokenizer="tok")))
    assert common.build_mesh(app.AppConfig()) is None
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        common.build_mesh(app.AppConfig(run=app.RunConfig(tp=2)))
    m = init_params(tiny_test_config(), seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 #8"):
        EngineBackend(m, ByteTokenizer(), mesh=object())
    assert EngineBackend(m, ByteTokenizer(), spec_decode=3).spec_decode == 3   # ported


@pytest.mark.parametrize("mode", ["batch", "paged"])
def test_engine_model_matches_jax(models, mode):
    """3 docs of in-memory frames, 8 greedy tokens: the responses, every
    per-sample row and the results equal the JAX EngineModel's."""
    kw = {"engine_mode": mode}
    if mode == "paged":
        kw.update(page_size=16, decode_steps=4)
    (o_rows, o_res), (r_rows, r_res) = reversed(_both(models, _docs(), **kw))
    assert o_rows == r_rows
    assert o_res == r_res
    assert o_res["samples"] == 3 and 0.0 <= o_res["accuracy"] <= 1.0
    assert any(r["resps"][0][0] for r in o_rows)


def test_loglikelihood_matches_jax(models):
    """A continuation's log-probability after a video question and after a
    text one, within 1e-4 of the JAX backend's; is_greedy equal."""
    jparams, model = models
    tok = ByteTokenizer(SPECIALS)
    questions = [("Which animal is it?", [_docs()[0]["video"]]), ("What color?", [])]
    conts = [" a dog", " blue"]
    ours = EngineModel(model, tok, **EVAL_KW).loglikelihood(
        [Instance(i, {}, t, v, {}) for i, (t, v) in enumerate(questions)],
        continuations=conts)
    ref = JEngineModel(jparams, j_tiny(), tok, **EVAL_KW).loglikelihood(
        [JInstance(i, {}, t, v, {}) for i, (t, v) in enumerate(questions)],
        continuations=conts)
    for (ll, greedy), (rll, rgreedy) in zip(ours, ref):
        assert abs(ll - rll) <= LL_TOL * max(1.0, abs(rll)), (ll, rll)
        assert greedy == rgreedy
    with pytest.raises(ValueError, match="continuation"):
        EngineModel(model, tok).loglikelihood([Instance(0, {}, "What color?", [], {})])


def test_non_rgb_visuals_match_jax(models):
    """Grayscale and RGBA images (PIL and arrays) become RGB one-frame clips,
    with the JAX backend's results."""
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (56, 56), np.uint8)
    rgba = rng.integers(0, 256, (56, 56, 4), np.uint8)
    docs = [{"video": v, "question": f"Q{i}?", "candidates": ["a", "b"], "answer": "a"}
            for i, v in enumerate([Image.fromarray(gray, mode="L"), rgba,
                                   Image.fromarray(rgba, mode="RGBA")])]
    (o_rows, o_res), (r_rows, r_res) = reversed(_both(models, docs))
    assert o_rows == r_rows and o_res == r_res


def test_generate_until_groups_by_gen_kwargs():
    """Instances with different gen_kwargs never share a batch, and the
    outputs come back in the instances' order."""
    backend = EngineBackend.__new__(EngineBackend)  # no model needed
    backend.batch_size = 4
    backend.engine_mode = "batch"
    backend.cache_hook = None
    backend._prepare = lambda inst: (list(range(len(inst.text))), [])
    seen = []

    def fake_run_batch(prepared, indices, gen_kwargs):
        seen.append((tuple(indices), dict(gen_kwargs)))
        return {i: f"out{i}" for i in indices}

    backend._run_batch = fake_run_batch
    instances = [Instance(doc_id=i, doc={}, text=t, visuals=[],
                          gen_kwargs={"max_new_tokens": m})
                 for i, (t, m) in enumerate([("aa", 8), ("bbbb", 64), ("c", 8), ("ddd", 64)])]
    assert backend.generate_until(instances) == ["out0", "out1", "out2", "out3"]
    assert len(seen) == 2
    for indices, kwargs in seen:
        mnts = {instances[i].gen_kwargs["max_new_tokens"] for i in indices}
        assert mnts == {kwargs["max_new_tokens"]}


def test_paged_pool_freed_on_regrowth(models, monkeypatch):
    """Ascending prompt lengths make the paged engine grow: it waits for
    the pool to drain, at least doubles max_len, and the old engine (its
    pool) is freed before the new one is allocated. The loader hands over
    one prepared instance per admission pass, so they arrive in turn."""
    from video_r2_tpu_torch.data import prefetch

    class OneAtATime(prefetch.PrefetchLoader):
        gave = False

        def poll(self):
            if self.gave:
                self.gave = False
                return None
            item = super().poll()
            self.gave = item is not None
            return item

    monkeypatch.setattr(prefetch, "PrefetchLoader", OneAtATime)
    _, model = models
    backend = EngineBackend(model, ByteTokenizer(SPECIALS), batch_size=2,
                            engine_mode="paged", page_size=16)
    instances = [Instance(doc_id=i, doc={}, text="x" * n, visuals=[],
                          gen_kwargs={"max_new_tokens": 4, "temperature": 0.0})
                 for i, n in enumerate([8, 40, 90, 200])]
    max_lens, alive_at_build = [], []
    old = []
    orig = backend._get_cont_engine

    def spy(needed):
        if backend._cont is None and old:
            gc.collect()
            alive_at_build.append([r() is not None for r in old])
        eng = orig(needed)
        if not max_lens or eng.max_len != max_lens[-1]:
            max_lens.append(eng.max_len)
            old.append(weakref.ref(eng))
        return eng

    backend._get_cont_engine = spy
    assert len(backend.generate_until(instances)) == 4
    assert len(max_lens) >= 2 and len(max_lens) <= 3, max_lens
    for a, b in zip(max_lens, max_lens[1:]):
        assert b >= 2 * a, max_lens
    assert alive_at_build and not any(any(x) for x in alive_at_build), alive_at_build


def test_run_eval_cli(models, tmp_path, monkeypatch):
    """apps/run_eval: the argument split, then its model-taking function on
    the CPU tiny model over a docs file naming mp4s under VIDEO_EVAL_ROOT
    (--limit 2): the samples file with the harness's keys and results.json,
    with the JAX backend's responses for the same docs."""
    _, model = models
    root = tmp_path / "videos"
    root.mkdir()
    docs = []
    for i in range(3):
        _write_mp4(root / f"v{i}.mp4", n=8 + 4 * i, hw=(56, 56))
        docs.append({"video": f"v{i}.mp4", "question": f"What is in video {i}?",
                     "candidates": ["a cat", "a dog"], "answer": "a dog"})
    (root / "v0.srt").write_text(SRT)
    docs_file = tmp_path / "docs.json"
    docs_file.write_text(json.dumps(docs))
    monkeypatch.setenv("VIDEO_EVAL_ROOT", str(root))
    out_dir = tmp_path / "out"
    argv = ["--tasks", "mvbench_think", "--docs", str(docs_file), "--limit", "2",
            "--run.model_preset", "tiny-test", "--run.output_dir", str(out_dir),
            "--eval.max_num_frames", "4", "--eval.max_pixels", str(56 * 56),
            "--eval.min_pixels", str(4 * 28 * 28), "--eval.batch_size", "2"]
    a, tasks, docs_arg, limit = run_eval.parse_args(argv)
    assert (tasks, docs_arg, limit) == ("mvbench_think", str(docs_file), 2)
    assert (a.run.model_preset, a.eval.max_num_frames, a.eval.batch_size) == (
        "tiny-test", 4, 2)
    out = run_eval.run_eval(a, model, ByteTokenizer(SPECIALS), tasks, docs_arg, limit)
    rows = [json.loads(line) for line in open(out_dir / "samples_mvbench_think.jsonl")]
    assert len(rows) == 2
    for row in rows:
        for key in ("doc_id", "doc", "input", "resps", "filtered_resps", "target",
                    "doc_hash", "accuracy"):
            assert key in row, key
    results = json.load(open(out_dir / "results.json"))
    assert results["results"]["mvbench_think"]["samples"] == 2
    assert (out_dir / "cache" / "cache_mvbench_think.jsonl").exists()
    jparams, _ = models
    jtask = j_get_task("mvbench_think", dataset_path=str(docs_file))
    ref = j_evaluate(JEngineModel(jparams, j_tiny(), ByteTokenizer(SPECIALS),
                                  max_num_frames=4, max_pixels=56 * 56,
                                  min_pixels=4 * 28 * 28, batch_size=2), [jtask], limit=2)
    assert [r["resps"] for r in rows] == [r["resps"] for r in ref["samples"]["mvbench_think"]]
    assert out["results"]["mvbench_think"]["accuracy"] == \
        ref["results"]["mvbench_think"]["accuracy"]


def test_run_eval_main_raises_without_a_card(tmp_path):
    """main builds its model on the card; with no CUDA device it raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would build the model on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_eval.main(["--run.model_preset", "tiny-test", "--tasks", "mvbench_think",
                       "--docs", str(tmp_path / "docs.json"), "--limit", "2"])


def test_demo_answer_from_a_file_matches_jax(models, tmp_path):
    """DemoRunner.answer on an mp4 with its .srt burned in: the JAX demo's
    answer, token for token; the web UI serves the form and the answer."""
    jparams, model = models
    path = _write_mp4(tmp_path / "demo.mp4", n=20, hw=(56, 84))
    (tmp_path / "demo.srt").write_text(SRT)
    tok = ByteTokenizer(SPECIALS)
    kw = dict(nframes=4, srt_path=str(tmp_path / "demo.srt"), max_new_tokens=6)
    ours = DemoRunner(model, tok, impl="xla").answer(path, "What moves?", **kw)
    ref = jdemo.DemoRunner(jparams, j_tiny(), tok, impl="xla").answer(path, "What moves?", **kw)
    assert ours == ref

    class Fake:
        def answer(self, video, question, nframes, srt_path):
            return f"{video}|{question}|{nframes}|{srt_path}"

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(Fake()))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/"
        assert "Video path" in urllib.request.urlopen(url, timeout=10).read().decode()
        body = "video=a.mp4&question=Why%3F&nframes=8&srt=".encode()
        page = urllib.request.urlopen(url, data=body, timeout=10).read().decode()
        assert "a.mp4|Why?|8|None" in page
    finally:
        server.shutdown()
