"""The PyTorch port's host code against the JAX package's originals.

The port copies the jax-free host helpers it needs (the JAX subpackages'
``__init__``s import jax). Each copy must equal its original exactly: every
comparison here is bit-exact (integers, strings, and float32 patches built by
the same numpy code). The first test proves the port never imports jax.
"""

import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from video_r2_tpu import config as japp
from video_r2_tpu.data import config as jdata_config
from video_r2_tpu.data import constants as jconstants
from video_r2_tpu.data import conversion as jconversion
from video_r2_tpu.engine import chat as jchat
from video_r2_tpu.evalharness.api import THINK_POST_PROMPT as J_THINK
from video_r2_tpu.models import config as jconfig
from video_r2_tpu.models.mrope import get_rope_index as j_get_rope_index
from video_r2_tpu.models.vision import plan_vision_layout as j_plan
from video_r2_tpu.rewards import judge as jjudge
from video_r2_tpu.video import device_preprocess as jpre
from video_r2_tpu.video import geometry as jgeo
from video_r2_tpu_torch import config as app
from video_r2_tpu_torch.apps.demo import THINK_POST_PROMPT
from video_r2_tpu_torch.data import config as data_config
from video_r2_tpu_torch.data import constants
from video_r2_tpu_torch.data import conversion
from video_r2_tpu_torch.engine import chat
from video_r2_tpu_torch.models import config
from video_r2_tpu_torch.models.mrope import get_rope_index
from video_r2_tpu_torch.models.vision import plan_vision_layout
from video_r2_tpu_torch.rewards import judge
from video_r2_tpu_torch.video import geometry as geo
from video_r2_tpu_torch.video import preprocess as pre

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import sys, pkgutil, importlib
sys.modules["jax"] = None            # any `import jax` now raises ImportError
sys.modules["cv2"] = None            # the card's machine has neither cv2 nor PIL
sys.modules["PIL"] = None
import video_r2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("ops.paged_attention", "engine.continuous", "engine.sampling",
             "ops.moe_ragged", "ops.moe_gmm", "models.moe", "models.quant",
             "engine.server", "rewards.judge", "ops.int4_matmul",
             "ops.decode_attention", "ops.int8_matmul", "rewards.accuracy",
             "rewards.format", "rewards.parsing", "rewards.embedding",
             "rewards.temporal", "rewards.registry", "train.grpo", "train.grpo_runner",
             "ops.logprobs", "data.grpo", "apps.train_grpo", "utils.profiling",
             "video.reader", "video.overlay", "video.srt", "video.cache", "data.prefetch",
             "evalharness.engine_backend", "evalharness.runner", "evalharness.regression",
             "evalharness.tasks.benchmarks", "evalharness.tasks.tempcompass",
             "apps.common", "apps.run_eval", "apps.demo", "evalharness.tac",
             "evalharness.vas", "evalharness.postprocess", "apps.serve", "apps.postprocess",
             "apps.test_judge", "models.attention_tap", "models.qwen3_next",
             "engine.next_continuous"):
    assert pkg.__name__ + "." + name in names, name
assert not any(k == "jax" or k.startswith(("jax.", "video_r2_tpu."))
               for k in sys.modules if sys.modules[k] is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20   # every module was walked


@pytest.mark.parametrize("name", ["qwen25vl_7b", "tiny_test_config", "qwen3_moe_30b_a3b",
                                  "qwen25vl_3b", "qwen25vl_72b"])
def test_config_copy_matches(name):
    """Every field the port keeps equals the JAX config's, nested ones too."""
    ours, ref = getattr(config, name)(), getattr(jconfig, name)()
    for sub in ("vision", "text", None):
        a = getattr(ours, sub) if sub else ours
        b = getattr(ref, sub) if sub else ref
        for f in dataclasses.fields(a):
            if f.name not in ("vision", "text"):
                assert getattr(a, f.name) == getattr(b, f.name), (sub, f.name)
    assert ours.text.head_dim == ref.text.head_dim


@pytest.mark.parametrize("hw", [(240, 320), (1080, 1920), (392, 392),
                                (100, 3000), (28, 28), (4000, 600)])
def test_geometry_copy_matches(hw):
    h, w = hw
    for kw in ({}, {"min_pixels": 128 * 28 * 28, "max_pixels": 768 * 28 * 28}):
        assert geo.smart_resize(h, w, **kw) == jgeo.smart_resize(h, w, **kw)
    for ele in ({"nframes": 8}, {"fps": 2.0}, {"fps": 1.0, "max_frames": 16},
                {"fps": 2.0, "video_start": 1.0, "video_end": 9.5,
                 "window_divisible": True}):
        ours = geo.plan_video_geometry(ele, 300, 29.97, native_height=h,
                                       native_width=w)
        ref = jgeo.plan_video_geometry(ele, 300, 29.97, native_height=h,
                                       native_width=w)
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
        assert ours.grid_thw == ref.grid_thw
    assert geo.snap_to_window(h, w, 768 * 28 * 28) == jgeo.snap_to_window(
        h, w, 768 * 28 * 28)
    assert geo.format_hhmmss(h * 7.3) == jgeo.format_hhmmss(h * 7.3)


def test_chat_copy_matches():
    msgs = [{"role": "user", "content": [
        {"type": "video", "video": "a.mp4"},
        {"type": "image", "image": "b.png"},
        {"type": "text", "text": "Why? é" + THINK_POST_PROMPT}]},
        {"role": "assistant", "content": "ok"}]
    assert THINK_POST_PROMPT == J_THINK
    for gen in (True, False):
        assert (chat.render_messages(msgs, add_generation_prompt=gen)
                == jchat.render_messages(msgs, add_generation_prompt=gen))
    text = chat.render_messages(msgs)
    expanded = chat.expand_vision_placeholders(text, [7], [3])
    assert expanded == jchat.expand_vision_placeholders(text, [7], [3])
    tok, jtok = chat.ByteTokenizer(), jchat.ByteTokenizer()
    ids = tok.encode(expanded)
    assert ids == jtok.encode(expanded)
    assert tok.decode(ids, False) == jtok.decode(ids, False)
    assert tok.decode(ids) == jtok.decode(ids)
    lists = [ids, ids[:50], ids[:130]]
    a, b = chat.pack_prompts(lists, 0), jchat.pack_prompts(lists, 0)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.lengths, b.lengths)


@pytest.mark.parametrize("thw_target", [
    ((4, 112, 168), (112, 168)),     # no resize
    ((5, 100, 150), (112, 168)),     # PIL resize, odd frame count
])
def test_preprocess_copy_matches(thw_target):
    (t, h, w), (th, tw) = thw_target
    frames = np.random.default_rng(t).integers(0, 256, (t, h, w, 3), np.uint8)
    ours = pre.preprocess_frames_host(frames, th, tw)
    ref = jpre.preprocess_frames_host(frames, th, tw)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    assert pre.grid_thw_for(t, th, tw) == jpre.grid_thw_for(t, th, tw)


def _video_ids(cfg, grids, rng, pad_to=None):
    ids = [int(x) for x in rng.integers(2, 400, 5)]
    for (t, h, w) in grids:
        ids += [cfg.vision_start_token_id] + [cfg.video_token_id] * (t * h * w // 4)
        ids += [cfg.vision_end_token_id] + [int(x) for x in rng.integers(2, 400, 3)]
    if pad_to:
        ids += [cfg.pad_token_id] * (pad_to - len(ids))
    return ids


@pytest.mark.parametrize("case", ["text_mask", "one_video_fractional",
                                  "two_videos_batch_mask"])
def test_get_rope_index_copy_matches(case):
    cfg = config.tiny_test_config()
    rng = np.random.default_rng(7)
    if case == "text_mask":
        ids = rng.integers(2, 400, (2, 11))
        mask = np.ones_like(ids)
        mask[1, 8:] = 0
        kw = dict(attention_mask=mask)
    elif case == "one_video_fractional":
        ids = np.array([_video_ids(cfg, [(3, 4, 6)], rng)])
        kw = dict(video_grid_thw=np.array([(3, 4, 6)]),
                  second_per_grid_ts=np.array([0.7]))
    else:
        grids = [(2, 4, 4), (4, 8, 12), (1, 4, 8)]
        row0 = _video_ids(cfg, grids[:2], rng)
        row1 = _video_ids(cfg, grids[2:], rng, pad_to=len(row0))
        ids = np.array([row0, row1])
        mask = (ids != cfg.pad_token_id).astype(np.int64)
        kw = dict(video_grid_thw=np.array(grids),
                  second_per_grid_ts=np.array([1.5, 0.25, 2.0]),
                  attention_mask=mask)
    ours = get_rope_index(ids, cfg, **kw)
    ref = j_get_rope_index(ids, jconfig.tiny_test_config(), **kw)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("grids", [[(4, 28, 28)], [(2, 8, 12)],
                                   [(2, 10, 6), (1, 4, 4), (3, 14, 22)]])
def test_plan_vision_layout_copy_matches(grids):
    ours = plan_vision_layout(grids, config.VisionConfig())
    ref = j_plan(grids, jconfig.VisionConfig())
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_data_copies_match():
    """data/constants.py, data/config.py and data/conversion.py equal the
    JAX package's."""
    names = [n for n in vars(jconstants) if n.isupper()]
    assert names and all(getattr(constants, n) == getattr(jconstants, n) for n in names)
    assert (dataclasses.asdict(data_config.DataConfig())
            == dataclasses.asdict(jdata_config.DataConfig()))
    conv = [{"from": "human", "value": "<video>\nWhat?\n<image>"},
            {"from": "gpt", "value": "It is <video> here."}]
    for is_video in (False, True):
        for strip in (False, True):
            assert (conversion.llava_to_openai(conv, is_video, strip)
                    == jconversion.llava_to_openai(conv, is_video, strip))


def test_app_config_copy_matches():
    """Every field the port's config keeps has the JAX default, and the same
    command line parses to the same values."""
    ours, ref = app.AppConfig(), japp.AppConfig()
    for section in ("run", "data", "optim", "sft", "grpo", "lora"):
        a, b = getattr(ours, section), getattr(ref, section)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (section, f.name)
    argv = ["--run.max_steps", "7", "--run.use_lora=true", "--lora.r", "16",
            "--optim.vision_lr", "3e-6", "--lora.targets", "attn,q,kernel",
            "--data.fps", "2.0", "--sft.ce_chunk_size=512", "--grpo.reward_weights",
            "1,0.5,2", "--grpo.rollout_backend=paged", "--grpo.beta", "0.0"]
    ours, ref = app.parse_config(argv), japp.parse_config(argv)
    assert (ours.run.max_steps, ours.run.use_lora, ours.lora.r, ours.optim.vision_lr,
            ours.lora.targets, ours.data.fps, ours.sft.ce_chunk_size) == (
        ref.run.max_steps, ref.run.use_lora, ref.lora.r, ref.optim.vision_lr,
        ref.lora.targets, ref.data.fps, ref.sft.ce_chunk_size)
    assert dataclasses.asdict(ours.grpo) == dataclasses.asdict(ref.grpo)
    assert ours.model_config() == config.qwen25vl_7b()


def test_judge_copy_matches():
    """rewards/judge.py's functions and classes are the original's source,
    line for line, and the server's stop helpers behave alike."""
    from video_r2_tpu.engine import server as jserver
    from video_r2_tpu_torch.engine import server

    for name in ("JudgeClient", "OpenAICompatClient", "chat_many", "EngineJudge",
                 "StaticJudge"):
        assert inspect.getsource(getattr(judge, name)) == inspect.getsource(
            getattr(jjudge, name)), name
    reqs = [("sys", f"user {i}") for i in range(3)]
    ours, ref = judge.StaticJudge(["a", "b"]), jjudge.StaticJudge(["a", "b"])
    assert judge.chat_many(ours, reqs) == jjudge.chat_many(ref, reqs) == ["a", "b", "b"]
    assert ours.calls == ref.calls == reqs
    for stop in (None, "", "ST", ["ST", "", "x"]):
        assert server._norm_stop(stop) == jserver._norm_stop(stop)
        assert (server._apply_stop("a xST b", server._norm_stop(stop))
                == jserver._apply_stop("a xST b", jserver._norm_stop(stop)))
    assert (app.AppConfig(run=app.RunConfig(model_preset="qwen3-moe-30b-a3b"))
            .model_config() == config.qwen3_moe_30b_a3b())


@pytest.mark.parametrize("name", ["parsing", "format", "accuracy", "embedding", "temporal",
                                  "registry"])
def test_reward_copies_match(name):
    """Each reward module's functions and classes are the original's source,
    line for line, and its constants are equal; load_reward_funcs finds the
    same names."""
    import importlib

    ours = importlib.import_module(f"video_r2_tpu_torch.rewards.{name}")
    ref = importlib.import_module(f"video_r2_tpu.rewards.{name}")
    defs = [n for n, v in vars(ref).items()
            if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == ref.__name__]
    assert defs
    for n in defs:
        assert inspect.getsource(getattr(ours, n)) == inspect.getsource(getattr(ref, n)), n
    for n in (n for n in vars(ref) if n.isupper()):
        assert getattr(ours, n) == getattr(ref, n), n
    if name == "registry":
        from video_r2_tpu.rewards.registry import _discover as j_discover

        assert sorted(ours._discover()) == sorted(j_discover())
        names = ["accuracy", "format_reward",
                 "temporal_grounding_sentence_embedding_consistency_reward"]
        assert [f.__name__ for f in ours.load_reward_funcs(names)] == [
            f.__name__ for f in ref.load_reward_funcs(names)]
        with pytest.raises(ValueError, match="Unknown reward"):
            ours.load_reward_funcs(["nope"])


def test_grpo_host_copies_match():
    """The GRPO host functions, the phase timer and the package exports
    equal the originals."""
    from video_r2_tpu import rewards as jrewards
    from video_r2_tpu.train import grpo as jgrpo
    from video_r2_tpu.utils import profiling as jprofiling
    from video_r2_tpu_torch import rewards
    from video_r2_tpu_torch.train import grpo
    from video_r2_tpu_torch.utils import profiling

    for n in ("completion_mask_from_ids", "combine_rewards", "compute_advantages"):
        assert inspect.getsource(getattr(grpo, n)) == inspect.getsource(getattr(jgrpo, n)), n
    for n in ("PhaseTimer", "profiling_phase"):
        assert inspect.getsource(getattr(profiling, n)) == inspect.getsource(
            getattr(jprofiling, n)), n
    assert rewards.__all__ == jrewards.__all__
    timer = profiling.PhaseTimer()
    for _ in range(2):
        with profiling.profiling_phase(timer, "a"):
            pass
    assert list(timer.metrics()) == ["profiling/a_s"] and timer.metrics() == {}
