"""The port's LoRA SFT slice against the JAX package, on the CPU.

Tiny config in float32, the same base weights and adapters in both packages
(load_jax_params, load_jax_lora). The JAX step runs attn_impl="xla", its own
CPU route (tests/test_ops.py holds its kernels to that route); the port runs
attn_impl="flash" and the ViT's "kernel" path, i.e. the autograd Functions
the card runs, with their plain steps on the CPU. Tolerances:

- optimizer against optax on fixed gradients: atol 5e-6 on O(1) values
  after three updates of lr <= 0.1: optax forms Adam's bias corrections in
  float32 (1 - 0.999 ** t is off by ~1e-5 relative there), the port in
  float64 (within 5e-8 of a float64 reference on this test's inputs);
- LoRA forward / merge: 5e-4 of the logits' scale. The model tests bound a
  forward with video at 3e-4 (the ViT's float32 sums in another order);
  adapters in the tower (B != 0 here) enlarge its activations, and the
  attached forward measured 3.5e-4 at most;
- the slice, step 1: loss rtol 2e-5; the adapter gradients as one vector,
  relative L2 2e-3: both packages' float32 gradients sit 4e-4 (6e-5
  without video) from a float64 run of the port, as the frozen ViT's
  float32 rounding reaches every decoder layer; A's gradient is exactly 0
  in both, as B starts at 0. Steps 2-3: loss rtol 1e-4, after two Adam
  updates that carry those differences on. The tower trains at vision_lr
  1e-4 there: Adam's first update moves every element by ~lr whatever its
  gradient's size, so the two ViT gradient elements that sit at float32
  noise (opposite signs in the two packages) would otherwise move 2e-2
  apart and dominate the later losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_r2_tpu.data.config import DataConfig as JDataConfig
from video_r2_tpu.data.sft import SFTCollator as JSFTCollator
from video_r2_tpu.data.sft import SFTDataset as JSFTDataset
from video_r2_tpu.engine.chat import ByteTokenizer as JByteTokenizer
from video_r2_tpu.models.config import tiny_test_config as j_tiny
from video_r2_tpu.models.loader import init_params as j_init
from video_r2_tpu.models.model import forward as j_forward
from video_r2_tpu.train import lora as jlora
from video_r2_tpu.train.optim import OptimConfig as JOptimConfig
from video_r2_tpu.train.optim import make_optimizer as j_make_optimizer
from video_r2_tpu.train.sft import SFTConfig as JSFTConfig
from video_r2_tpu.train.sft import init_train_state as j_init_train_state
from video_r2_tpu.train.sft import make_sft_step as j_make_sft_step
from video_r2_tpu.train.sft import sft_loss as j_sft_loss
from video_r2_tpu_torch.apps.demo import DemoRunner
from video_r2_tpu_torch.apps.train_sft import train
from video_r2_tpu_torch.config import AppConfig, RunConfig
from video_r2_tpu_torch.data.config import DataConfig
from video_r2_tpu_torch.data.sft import SFTCollator, SFTDataset
from video_r2_tpu_torch.engine.chat import ByteTokenizer
from video_r2_tpu_torch.models.config import tiny_test_config
from video_r2_tpu_torch.models.convert import (
    flatten_jax_tree,
    load_jax_lora,
    load_jax_params,
)
from video_r2_tpu_torch.models.layers import Linear
from video_r2_tpu_torch.models.loader import init_params
from video_r2_tpu_torch.models.model import forward
from video_r2_tpu_torch.train.lora import (
    LoRAConfig,
    attach_lora,
    detach_lora,
    init_lora,
    lora_param_count,
    merge_lora,
)
from video_r2_tpu_torch.train.optim import GroupedAdamW, OptimConfig
from video_r2_tpu_torch.train.sft import (
    SFTConfig,
    init_train_state,
    make_lora_sft_step,
    make_sft_step,
    sft_loss,
)
from video_r2_tpu_torch.video.api import video_features

T = torch.from_numpy
# ByteTokenizer with the tiny config's special ids (all below its vocab of 512)
SPECIALS = {"<|endoftext|>": 0, "<|im_start|>": 300, "<|im_end|>": 1,
            "<|vision_start|>": 502, "<|vision_end|>": 503,
            "<|image_pad|>": 500, "<|video_pad|>": 501}
# frames at their target size; min / max pixels keep the tiny sizes as they are
DATA = dict(video_min_pixels=4 * 28 * 28, video_max_pixels=112 * 168,
            pad_to_multiple=16)


def _records(seed=0):
    """Two frame-passthrough records: 4 frames at 112x168 (grid (2, 8, 12),
    a full and a ragged window per frame pair) and 6 at 56x84."""
    rng = np.random.default_rng(seed)
    out = []
    for n, (h, w), q, a in ((4, (112, 168), "What moves?", "left"),
                            (6, (56, 84), "Count them.", "three")):
        out.append({
            "video": rng.integers(0, 256, (n, h, w, 3), np.uint8),
            "conversations": [
                {"from": "human", "value": f"<video>\n{q}"},
                {"from": "gpt", "value": f"<think>hmm</think><answer>{a}</answer>"}]})
    return out


def _batches(records):
    """(JAX batch, port batch) from the two packages' own collators."""
    jb = JSFTCollator(j_tiny(), JDataConfig(**DATA))(
        [JSFTDataset(records, JByteTokenizer(SPECIALS), j_tiny(), JDataConfig(**DATA))[i]
         for i in range(len(records))])
    pb = SFTCollator(tiny_test_config(), DataConfig(**DATA))(
        [SFTDataset(records, ByteTokenizer(SPECIALS), tiny_test_config(), DataConfig(**DATA))[i]
         for i in range(len(records))])
    return jb, pb


@pytest.fixture(scope="module")
def base():
    jparams = j_init(j_tiny(), seed=3)
    return jparams, jax.tree.map(np.asarray, jparams)


def _port_model(np_params):
    return load_jax_params(init_params(tiny_test_config(), seed=0, device="cpu"),
                           np_params)


def _close(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * scale)


def test_collator_matches_jax():
    jb, pb = _batches(_records())
    assert set(jb.arrays) == set(pb.arrays)
    for k, a in jb.arrays.items():
        assert pb.arrays[k].dtype == a.dtype, k
        np.testing.assert_array_equal(pb.arrays[k], a, err_msg=k)
    for f in dataclasses.fields(jb.video_layout):
        a, b = getattr(pb.video_layout, f.name), getattr(jb.video_layout, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)


def test_dataset_refuses_video_files(tmp_path):
    """Video files, which the dataset refused until the video reader was
    ported, now decode: a record naming an mp4 under image_folder (its .srt
    under video_subtitles_folder, timestamps and subtitles burned in) gives
    the JAX dataset's example exactly. Image records are still refused."""
    from tests.test_torch_video import SRT, _write_mp4

    _write_mp4(tmp_path / "clip.mp4", n=30, hw=(56, 84))
    (tmp_path / "subs").mkdir()
    (tmp_path / "subs" / "clip.srt").write_text(SRT)
    rec = {"video": "clip.mp4", "video_fps": 5.0, "conversations": [
        {"from": "human", "value": "<video>\nWhat moves?"},
        {"from": "gpt", "value": "<think>hmm</think><answer>left</answer>"}]}
    dkw = dict(DATA, image_folder=str(tmp_path), video_subtitles_folder=str(tmp_path / "subs"),
               write_timestamps=True, write_subtitles=True)
    ours = SFTDataset([rec], ByteTokenizer(SPECIALS), tiny_test_config(), DataConfig(**dkw))[0]
    ref = JSFTDataset([rec], JByteTokenizer(SPECIALS), j_tiny(), JDataConfig(**dkw))[0]
    for f in ("input_ids", "labels", "video_patches"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    assert ours.video_grid_thw == ref.video_grid_thw
    assert ours.second_per_grid_ts == ref.second_per_grid_ts
    plain = SFTDataset([rec], ByteTokenizer(SPECIALS), tiny_test_config(),
                       DataConfig(**dict(dkw, write_timestamps=False,
                                         write_subtitles=False)))[0]
    assert not np.array_equal(plain.video_patches, ours.video_patches)
    ds = SFTDataset([{"image": "a.jpg", "conversations": []}], ByteTokenizer(),
                    tiny_test_config(), DataConfig())
    with pytest.raises(NotImplementedError, match="image inputs"):
        ds[0]


@pytest.mark.parametrize("warmup,schedule", [(0.0, "cosine"), (0.4, "cosine"),
                                             (0.4, "constant")])
def test_optimizer_matches_optax(rng, warmup, schedule):
    """Three updates on a two-group tree, the decoder group clipped (norm
    above max_grad_norm), the vision group not; with warmup the first
    update has lr 0."""
    kw = dict(learning_rate=0.1, vision_lr=0.05, weight_decay=0.01,
              warmup_ratio=warmup, total_steps=5, max_grad_norm=1.0, schedule=schedule)
    shapes = {"model.layers.w": (3, 4), "model.layers.scale": (4,), "visual.blocks.w": (2, 3)}
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * (5.0 if n.startswith("model") else 0.1)
                  ).astype(np.float32) for n, s in shapes.items()} for _ in range(3)]

    def tree(flat):
        return {"model": {"layers": {"w": flat["model.layers.w"],
                                     "scale": flat["model.layers.scale"]}},
                "visual": {"blocks": {"w": flat["visual.blocks.w"]}}}

    jparams = jax.tree.map(jnp.asarray, tree(init))
    jopt = j_make_optimizer(JOptimConfig(**kw), jparams)
    jstate = jopt.init(jparams)
    params = {n: torch.nn.Parameter(T(a.copy())) for n, a in init.items()}
    opt = GroupedAdamW(OptimConfig(**kw), params.items())
    assert len(opt.optimizer.param_groups) == 3
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, tree(g)), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in params.items():
            p.grad = T(g[n].copy())
        opt.step()
    ref = jax.tree.map(np.asarray, jparams)
    for n, p in params.items():
        top, mid, leaf = n.split(".")
        np.testing.assert_allclose(p.detach().numpy(), ref[top][mid][leaf], rtol=0,
                                   atol=5e-6, err_msg=n)


@pytest.mark.parametrize("include_vision", [False, True], ids=["decoder", "tower"])
def test_lora_attach_and_merge_match_jax(base, rng, include_vision):
    """Targets (vision excluded by default), the attached forward and the
    merged model against the JAX package's, on adapters with B != 0."""
    jparams, np_params = base
    jcfg = jlora.LoRAConfig(r=4, alpha=8, include_vision=include_vision)
    cfg = LoRAConfig(r=4, alpha=8, include_vision=include_vision)
    jl = jlora.init_lora(jparams, jcfg, seed=1)
    jl = jax.tree.map(lambda x: x + 0.05 * jnp.asarray(rng.normal(size=x.shape),
                                                       jnp.float32), jl)
    model = _port_model(np_params)
    lora = init_lora(model, cfg, seed=0)
    assert all(float(v.abs().max()) == 0 for n, v in lora.items() if n.endswith("lora_b"))
    params = attach_lora(model, lora, cfg)
    load_jax_lora(model, jax.tree.map(np.asarray, jl))     # same adapter set, or raises
    names = set(params)
    assert any(n.startswith("visual.blocks") for n in names) == include_vision
    assert not any(n.startswith(("visual.merger", "lm_head", "model.embed")) for n in names)
    assert lora_param_count(params) == sum(x.size for x in jax.tree.leaves(jl))

    jb, pb = _batches(_records(1))
    jargs = dict(attention_mask=jnp.asarray(jb.arrays["attention_mask"]),
                 video_patches=jnp.asarray(jb.arrays["video_patches"]),
                 video_layout=jb.video_layout)
    pargs = dict(attention_mask=T(pb.arrays["attention_mask"]),
                 video_patches=T(pb.arrays["video_patches"]), video_layout=pb.video_layout)
    ids, pos = jb.arrays["input_ids"], jb.arrays["position_ids"]
    rows = jb.arrays["attention_mask"] == 1
    with torch.no_grad():
        ref, _ = j_forward(jlora.attach_lora(jparams, jl, jcfg), j_tiny(),
                           jnp.asarray(ids), jnp.asarray(pos), **jargs)
        _close(forward(model, T(ids), T(pos), **pargs).numpy()[rows],
               np.asarray(ref)[rows], 5e-4)
        merged = merge_lora(model)
        ref, _ = j_forward(jlora.merge_lora(jparams, jl, jcfg), j_tiny(),
                           jnp.asarray(ids), jnp.asarray(pos), **jargs)
        _close(forward(merged, T(ids), T(pos), **pargs).numpy()[rows],
               np.asarray(ref)[rows], 5e-4)
    assert all(m.lora_a is None for m in merged.modules() if isinstance(m, Linear))
    assert not any(p.requires_grad for p in merged.parameters())
    feats = video_features(_records(4)[1]["video"][:4], 56, 84, sample_fps=2.0)
    runner = DemoRunner(merged, ByteTokenizer(SPECIALS))
    res = runner.generate(runner.prepare(feats, "Why?"), 3)
    assert res.sequences.shape == (1, 3) and 1 <= res.lengths[0] <= 3
    assert model.model.layers[0].attn.q.lora_a is params["model.layers.0.attn.q.lora_a"]
    detach_lora(model)
    assert not any(n.endswith("lora_a") for n, _ in model.named_parameters())


@pytest.mark.parametrize("include_vision", [False, True], ids=["frozen_tower", "tower"])
def test_lora_sft_steps_match_jax(base, include_vision):
    """Three LoRA SFT steps with video on the same batch: step-1 loss and
    adapter gradients, then the losses of steps 2 and 3."""
    jparams, np_params = base
    lkw = dict(r=4, alpha=8, include_vision=include_vision, include_merger=include_vision)
    jcfg, cfg = jlora.LoRAConfig(**lkw), LoRAConfig(**lkw)
    okw = dict(learning_rate=2e-2, vision_lr=1e-4, merger_lr=2e-2, total_steps=3)
    jb, pb = _batches(_records(2))
    jbatch = {k: jnp.asarray(v) for k, v in jb.arrays.items()}
    batch = {k: T(v) for k, v in pb.arrays.items()}

    # JAX: its step-1 gradients, then three steps of its LoRA trainer
    jl = jlora.init_lora(jparams, jcfg, seed=1)
    jscfg = JSFTConfig(ce_chunk_size=64, attn_impl="xla")
    jgrads = jax.grad(lambda l: j_sft_loss(jlora.attach_lora(jparams, l, jcfg), j_tiny(),
                                           jbatch, jscfg, jb.video_layout))(jl)
    jopt = j_make_optimizer(JOptimConfig(**okw), jl)
    jstep = jlora.make_lora_sft_step(jparams, j_tiny(), jscfg, jcfg, jopt,
                                     video_layout=jb.video_layout, donate=False)
    jstate = jlora.LoRATrainState(jl, jopt.init(jl), jnp.zeros((), jnp.int32))
    jlosses = []
    for _ in range(3):
        jstate, m = jstep(jstate, jbatch)
        jlosses.append(float(m["loss"]))

    # the port, on the same base and adapters
    model = _port_model(np_params)
    params = attach_lora(model, init_lora(model, cfg), cfg)
    load_jax_lora(model, jax.tree.map(np.asarray, jl))
    scfg = SFTConfig(ce_chunk_size=64, attn_impl="flash", vit_attn_impl="kernel")
    loss = sft_loss(model, batch, scfg, pb.video_layout)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jlosses[0], rtol=2e-5)
    ref = _adapter_names(jgrads)
    assert ref.keys() == params.keys()
    ours = np.concatenate([p.grad.numpy().ravel() for p in params.values()])
    want = np.concatenate([ref[n].ravel() for n in params])
    assert np.linalg.norm(ours - want) <= 2e-3 * np.linalg.norm(want)
    for n, p in params.items():
        if n.endswith("lora_a"):                          # B = 0 at init
            assert float(p.grad.abs().max()) == 0.0 and not ref[n].any(), n

    state = init_train_state(params, OptimConfig(**okw))
    step = make_lora_sft_step(model, scfg, pb.video_layout)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=2e-5)
    np.testing.assert_allclose(losses[1:], jlosses[1:], rtol=1e-4)
    assert state.step == 3 and losses[2] < losses[0]


def test_full_parameter_sft_steps_match_jax(base):
    """Full-parameter SFT (every weight trains, the tower at vision_lr):
    step-1 gradients of every parameter, then the losses of two steps, the
    second after one AdamW update of all 6 groups. Gradients: relative L2
    5e-3 per tensor (the ViT's parameters sit 2.1e-3 from a float64 run of
    the port in float32, the JAX package's 2.5e-3). Loss of step 2: rtol
    5e-4 (measured 1.6e-4): Adam's first update moves every element by
    ~lr whatever its gradient's size, so elements whose gradients sit at
    that float32 noise move apart by up to 2 lr."""
    jparams, np_params = base
    okw = dict(learning_rate=1e-3, vision_lr=1e-4, merger_lr=1e-3, total_steps=2)
    jb, pb = _batches(_records(5))
    jbatch = {k: jnp.asarray(v) for k, v in jb.arrays.items()}
    jscfg = JSFTConfig(ce_chunk_size=64)
    jgrads = flatten_jax_tree(jax.tree.map(np.asarray, jax.grad(
        lambda p: j_sft_loss(p, j_tiny(), jbatch, jscfg, jb.video_layout))(jparams)))
    jopt = j_make_optimizer(JOptimConfig(**okw), jparams)
    jstep = j_make_sft_step(j_tiny(), jscfg, jopt, video_layout=jb.video_layout,
                            donate=False)
    jstate = j_init_train_state(jparams, jopt)
    jlosses = []
    for _ in range(2):
        jstate, m = jstep(jstate, jbatch)
        jlosses.append(float(m["loss"]))

    model = _port_model(np_params).requires_grad_(True)
    scfg = SFTConfig(ce_chunk_size=64, attn_impl="flash", vit_attn_impl="kernel")
    batch = {k: T(v) for k, v in pb.arrays.items()}
    sft_loss(model, batch, scfg, pb.video_layout).backward()
    assert {n for n, _ in model.named_parameters()} == jgrads.keys()
    for n, p in model.named_parameters():
        want = jgrads[n]
        assert np.linalg.norm(p.grad.numpy() - want) <= 5e-3 * np.linalg.norm(want), n
    state = init_train_state(dict(model.named_parameters()), OptimConfig(**okw))
    assert len(state.optimizer.optimizer.param_groups) == 6
    step = make_sft_step(model, scfg, pb.video_layout)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=5e-4)
    assert losses[1] < losses[0]


def _adapter_names(tree):
    """A JAX adapter tree -> {port adapter name: array}."""
    out = {}
    for name, arr in flatten_jax_tree(jax.tree.map(np.asarray, tree)).items():
        kernel, leaf = name.rsplit(".", 1)
        out[f"{kernel.rsplit('.', 1)[0]}.lora_{leaf}"] = arr
    return out


def test_trainer_checkpoints_and_resumes(base, tmp_path):
    """train() for 2 steps writes checkpoint-2; a second run resumes there
    and takes only step 3, keeping the newest two checkpoints."""
    _, np_params = base
    app = AppConfig(run=RunConfig(model_preset="tiny-test", dtype="float32",
                                  output_dir=str(tmp_path), max_steps=2, save_steps=1,
                                  log_steps=1, use_lora=True),
                    data=DataConfig(**DATA), lora=LoRAConfig(r=4, alpha=8),
                    sft=SFTConfig(ce_chunk_size=64))
    records = _records(3)
    ds = SFTDataset(records, ByteTokenizer(SPECIALS), tiny_test_config(), app.data)
    state, history = train(app, _port_model(np_params), ds, batch_size=2)
    assert [h["step"] for h in history] == [1, 2] and state.step == 2
    assert (tmp_path / "checkpoint-2" / "state.pt").exists()
    assert all(np.isfinite(h["loss"]) and h["tokens"] > 0 for h in history)

    app3 = dataclasses.replace(app, run=dataclasses.replace(app.run, max_steps=3))
    state3, history3 = train(app3, _port_model(np_params), ds, batch_size=2)
    assert [h["step"] for h in history3] == [3] and state3.step == 3
    assert sorted(p.name for p in tmp_path.glob("checkpoint-*")) == [
        "checkpoint-2", "checkpoint-3"]
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 3
