"""Engine-backed eval generation (the qwen2_5_vl adapter equivalent).

Port of ``video_r2_tpu/evalharness/engine_backend.py`` onto the port's
engines: batch mode runs `engine/generate.py::generate` (prefill in row
chunks, the ViT a sample at a time), paged mode runs
`engine/continuous.py::PagedContinuousEngine` (continuous batching fed by
the prefetch loader). Instances are grouped by gen_kwargs, sorted by a
header-only cost estimate so padded shapes bucket tightly (the reference
sorts by length, qwen2_5_vl.py:184-199), run in fixed-size batches, and put
back in order.

Host preprocessing (`_prepare`: video decode, burn-in, patchify, tokenize)
runs on prefetch workers ahead of the card, and touches no torch CUDA state
(data/prefetch.py's contract), so forked workers under VR2_DECODE_PROCS
stay safe. spec_decode=K decodes speculatively (K n-gram drafts a verify
round; eval generation is greedy, so the answers are plain greedy's) in
batch mode and in paged mode. The JAX backend's mesh option raises until
the parallelism port (ROADMAP Queue 1 #8).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..engine.chat import expand_vision_placeholders, pack_prompts, render_messages
from ..engine.generate import generate
from ..engine.sampling import SamplingParams
from ..models.model import forward, lm_head_weight
from ..models.mrope import get_rope_index
from ..models.vision import plan_vision_layout, vit_forward
from ..video import VideoPreprocessConfig, fetch_video
from ..video.geometry import plan_video_geometry
from .api import Instance


class EngineBackend:
    def __init__(self, model, tokenizer, max_num_frames=128,
                 max_pixels=151200, min_pixels=100352, fps=None, batch_size=8,
                 system_prompt="You are a helpful assistant.",
                 attn_impl="auto", act_quant=None, kv_quant=None, seed=0,
                 engine_mode="batch", engine_max_len=None, page_size=128,
                 window_divisible=False, vit_act_quant=None,
                 prefill_rows="auto", decode_steps=8,
                 patch_dtype="float32", mesh=None, spec_decode=0):
        """model: a Qwen25VL module on its device (the card, or the CPU in
        tests). attn_impl: the decoder's prefill attention, "flash", "xla"
        or "auto" (flash on a CUDA device); the ViT picks its kernels by
        device. act_quant="int8": W8A8 prefill; kv_quant="int8": the int8
        KV cache (batch) or int8 pages (paged); vit_act_quant="int8": W8A8
        in the ViT (opt-in: it shifts vision activations). patch_dtype
        "float16" halves the host-to-device patch copy (the tower promotes
        it to the weights' type). The other options are the JAX backend's."""
        if mesh is not None:
            raise NotImplementedError("a mesh (multi-GPU eval) waits for the "
                                      "parallelism port (ROADMAP Queue 1 #8)")
        if engine_mode not in ("batch", "paged"):
            raise ValueError(f"unknown engine_mode {engine_mode!r}")
        if attn_impl == "auto":
            attn_impl = "flash" if model.device.type == "cuda" else "xla"
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.max_num_frames = max_num_frames
        self.max_pixels = max_pixels
        self.min_pixels = min_pixels
        self.fps = fps
        self.batch_size = batch_size
        self.system_prompt = system_prompt
        self.attn_impl = attn_impl
        self.act_quant = act_quant
        self.vit_act_quant = vit_act_quant
        self.kv_quant = kv_quant
        self.seed = seed
        self.vcfg = VideoPreprocessConfig(patch_dtype=patch_dtype)
        # "paged": continuous batching over the paged KV pool, so short
        # answers free their slot at once instead of decoding at the
        # longest sample's length
        self.engine_mode = engine_mode
        self.engine_max_len = engine_max_len
        self.page_size = page_size
        self.spec_decode = spec_decode
        # snap resize targets to 112-px ViT windows (video/geometry.py
        # snap_to_window); changes the input resolution, so off by default
        self.window_divisible = window_divisible
        # batch prefill in row chunks: "auto" takes the largest divisor of
        # the batch whose tokens stay under ~8k (a full B = 8 x ~3k-token
        # 7B prefill forms [B*S, 18944] MLP intermediates)
        self.prefill_rows = prefill_rows
        # paged mode: decode tokens per step() window
        self.decode_steps = decode_steps
        self._cont = None
        # incremental response persistence (runner.CacheHook); set per call
        # by EngineModel.generate_until
        self.cache_hook = None

    def _video_ele(self, visual) -> dict:
        ele = {"min_pixels": self.min_pixels, "max_pixels": self.max_pixels}
        if isinstance(visual, str):
            ele["video"] = visual
        else:
            arr = np.asarray(visual)
            if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] != 3):
                # grayscale / palette / RGBA images: to RGB as the image
                # path does (video/api.to_rgb)
                from ..video.api import _is_pil_image, _pil_image, to_rgb

                Image = _pil_image("a non-RGB image visual")
                arr = np.asarray(to_rgb(
                    visual if _is_pil_image(visual) else Image.fromarray(arr)))
            if arr.ndim == 3:
                # one image -> one temporal group (the frame doubled to
                # FRAME_FACTOR, grid t = 1)
                arr = np.stack([arr, arr])
            ele["video"] = arr
            ele["video_fps"] = 1.0
        if self.fps is not None:
            ele["fps"] = self.fps
        ele["max_frames"] = self.max_num_frames
        if self.window_divisible:
            ele["window_divisible"] = True
        return ele

    def _prepare(self, inst: Instance):
        """Host only: the visuals' features (numpy) and the prompt ids."""
        feats = [fetch_video(self._video_ele(visual), self.vcfg)
                 for visual in inst.visuals]
        messages = [{"role": "system", "content": self.system_prompt},
                    {"role": "user", "content": (
                        [{"type": "video", "video": "_"}] * len(feats)
                        + [{"type": "text", "text": inst.text}])}]
        text = render_messages(messages, default_system=None)
        text = expand_vision_placeholders(text, [f.num_tokens for f in feats], [])
        ids = self.tok.encode(text)
        return ids, feats

    @staticmethod
    def _apply_until(text: str, gen_kwargs: dict) -> str:
        """Trim at the task's stop strings (qwen2_5_vl.py:208-217,342-344:
        '\\n\\n' is dropped as a stopper to avoid truncating reasoning)."""
        until = gen_kwargs.get("until", [])
        if isinstance(until, str):
            until = [until]
        for term in until:
            if term and term != "\n\n":
                text = text.split(term)[0]
        return text

    def _estimate_cost(self, inst: Instance) -> tuple[int, int]:
        """Header-only (no decode) video-token estimate for the shape sort:
        a file's frame count, fps and size from its cv2 header, an array's
        from its shape, through plan_video_geometry (~ms a video)."""
        total = 0
        for visual in inst.visuals:
            ele = self._video_ele(visual)
            try:
                if isinstance(visual, str):
                    import cv2

                    cap = cv2.VideoCapture(visual)
                    try:
                        nf = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
                        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
                    finally:
                        cap.release()
                else:
                    arr = np.asarray(visual)
                    nf = 2 if arr.ndim == 3 else int(arr.shape[0])
                    h, w = int(arr.shape[-3]), int(arr.shape[-2])
                    fps = float(ele.get("video_fps", 1.0))
                geo = plan_video_geometry(ele, total_frames=max(nf, 2),
                                          video_fps=fps, native_height=h,
                                          native_width=w)
                t, gh, gw = geo.grid_thw
                total += t * gh * gw // 4
            except Exception:
                pass  # unsortable visual -> cost 0; correctness unaffected
        return (total, len(inst.text or ""))

    def generate_until(self, instances: list[Instance]) -> list[str]:
        # group by gen_kwargs first (a shape-sorted batch must not mix
        # requests with different max_new_tokens / temperature), then sort
        # each group by the header estimate
        groups: dict[str, list[int]] = {}
        for i, inst in enumerate(instances):
            key = repr(sorted((inst.gen_kwargs or {}).items()))
            groups.setdefault(key, []).append(i)
        schedule: list[tuple[list[int], dict]] = []  # (chunk idxs, gen_kwargs)
        for idxs in groups.values():
            order = sorted(idxs, key=lambda i: self._estimate_cost(instances[i]))
            gk = instances[order[0]].gen_kwargs
            if self.engine_mode == "paged":
                schedule.append((order, gk))
            else:
                for start in range(0, len(order), self.batch_size):
                    schedule.append((order[start: start + self.batch_size], gk))

        # host preprocessing runs on workers up to `prefetch` instances ahead
        # of the card, in schedule order: the next batch's decode overlaps
        # this batch's prefill and decode
        flat = [i for chunk, _ in schedule for i in chunk]
        from ..data.prefetch import PrefetchLoader

        # VR2_DECODE_PROCS=N: N forked worker processes in place of threads;
        # _prepare is host-only, so the fork is safe
        n_procs = int(os.environ.get("VR2_DECODE_PROCS", "0") or 0)
        if n_procs > 0 and self.vcfg.preprocess_backend != "host":
            raise ValueError("VR2_DECODE_PROCS requires preprocess_backend='host' "
                             "(forked decode workers run host code only)")
        loader = PrefetchLoader(
            ([i] for i in flat),
            lambda idx: self._prepare(instances[idx[0]]),
            num_workers=n_procs if n_procs > 0 else 4,
            prefetch=2 * self.batch_size,
            use_processes=n_procs > 0)
        results: dict[int, str] = {}
        hook = getattr(self, "cache_hook", None)
        try:
            for chunk, gk in schedule:
                if self.engine_mode == "paged":
                    results.update(self._run_continuous(loader, chunk, gk))
                else:
                    prepared = [next(loader) for _ in chunk]
                    results.update(self._run_batch(prepared, chunk, gk))
                if hook is not None:
                    # flush this batch's responses, so a crash later replays
                    # only what is not persisted yet
                    done = [i for i in chunk if i in results]
                    hook.add_partial([instances[i] for i in done],
                                     [results[i] for i in done])
        finally:
            loader.close()
        return [results[i] for i in range(len(instances))]

    def _vision_embeds(self, feats) -> torch.Tensor:
        """One sample's merged ViT embeddings on the model's device."""
        patches = torch.as_tensor(np.concatenate([f.patches for f in feats]),
                                  device=self.model.device)
        layout = plan_vision_layout([f.grid_thw for f in feats], self.cfg.vision)
        with torch.inference_mode():
            return vit_forward(self.model.visual, patches, layout,
                               act_quant=self.vit_act_quant)

    def loglikelihood(self, instances: list[Instance],
                      continuations: list[str] | None = None
                      ) -> list[tuple[float, bool]]:
        """(log P(continuation | context, visuals), is_greedy) per request,
        the lmms ABC's loglikelihood output type (api/model.py:29-50). The
        continuation comes from `continuations[i]` or
        inst.gen_kwargs["continuation"]; it is scored by an fp32 head over
        the decoder's hidden states and a log-softmax."""
        dev = self.model.device
        out = []
        for i, inst in enumerate(instances):
            cont = (continuations[i] if continuations is not None
                    else (inst.gen_kwargs or {}).get("continuation"))
            if cont is None:
                raise ValueError("loglikelihood needs a continuation per "
                                 "instance (continuations arg or "
                                 "gen_kwargs['continuation'])")
            ctx_ids, feats = self._prepare(inst)
            cont_ids = self.tok.encode(cont)
            ids = np.asarray([list(ctx_ids) + list(cont_ids)], np.int32)
            grids = [f.grid_thw for f in feats]
            spg = [f.second_per_grid_t for f in feats]
            pos, _ = get_rope_index(
                ids, self.cfg,
                video_grid_thw=np.asarray(grids) if grids else None,
                second_per_grid_ts=np.asarray(spg) if spg else None)
            patches = layout = None
            if feats:
                patches = torch.as_tensor(np.concatenate([f.patches for f in feats]),
                                          device=dev)
                layout = plan_vision_layout(grids, self.cfg.vision)
            with torch.inference_mode():
                hidden = forward(self.model, torch.as_tensor(ids, device=dev).long(),
                                 torch.as_tensor(np.asarray(pos), device=dev).long(),
                                 video_patches=patches, video_layout=layout,
                                 attn_impl=self.attn_impl, return_hidden=True)
                C = len(cont_ids)
                rows = hidden[0, len(ctx_ids) - 1: len(ctx_ids) - 1 + C]
                logits = rows.float() @ lm_head_weight(self.model).float()   # [C, V]
                logprobs = torch.log_softmax(logits, dim=-1)
                tok = torch.as_tensor(cont_ids, dtype=torch.long, device=dev)
                ll = float(logprobs[torch.arange(C, device=dev), tok].sum())
                greedy = bool((logits.argmax(-1) == tok).all())
            out.append((ll, greedy))
        return out

    def _sampling(self, gen_kwargs: dict) -> SamplingParams:
        temp = float(gen_kwargs.get("temperature", 0.0))
        return SamplingParams(
            do_sample=gen_kwargs.get("do_sample", temp > 0),
            temperature=temp if temp > 0 else 1.0,
            top_p=float(gen_kwargs.get("top_p", 1.0)),
            top_k=int(gen_kwargs.get("top_k", 0)),
            max_new_tokens=int(gen_kwargs.get("max_new_tokens", 1024)),
            eos_token_ids=(self.cfg.eos_token_id,),
            pad_token_id=self.cfg.pad_token_id)

    def _run_batch(self, prepared, indices, gen_kwargs):
        packed = pack_prompts([ids for ids, _ in prepared],
                              pad_id=self.cfg.pad_token_id)
        grids = [f.grid_thw for _, feats in prepared for f in feats]
        spg = [f.second_per_grid_t for _, feats in prepared for f in feats]
        mask = (np.arange(packed.input_ids.shape[1])[None, :]
                < packed.lengths[:, None]).astype(np.int64)
        pos, deltas = get_rope_index(
            packed.input_ids, self.cfg,
            video_grid_thw=np.asarray(grids) if grids else None,
            second_per_grid_ts=np.asarray(spg) if spg else None,
            attention_mask=mask)
        embeds = None
        if grids:
            # the ViT a sample at a time, not one batch-wide call: the
            # activation peak stays one clip's
            embeds = torch.cat([self._vision_embeds(feats)
                                for _, feats in prepared if feats])
        sp = self._sampling(gen_kwargs)
        self.seed += 1
        B, S = packed.input_ids.shape
        pc = self.prefill_rows
        if pc == "auto":
            pc = next((d for d in range(B, 0, -1)
                       if B % d == 0 and d * S <= 8192), 1)
        pc = pc if pc and pc < B else None
        res = generate(self.model, packed.input_ids, packed.lengths, sp,
                       position_ids=pos, rope_deltas=deltas[:, 0],
                       vision_embeds=embeds,
                       vision_token_id=self.cfg.video_token_id,
                       seed=self.seed, attn_impl=self.attn_impl,
                       act_quant=self.act_quant, kv_quant=self.kv_quant,
                       prefill_chunk=pc, spec_decode=self.spec_decode)
        out = {}
        for row, idx in enumerate(indices):
            ids = res.sequences[row][: res.lengths[row]]
            out[idx] = self._apply_until(
                self.tok.decode(ids, skip_special_tokens=True), gen_kwargs)
        return out

    # -- continuous-batching path -------------------------------------------
    def _get_cont_engine(self, needed_len: int):
        from ..engine.continuous import PagedContinuousEngine

        if self._cont is not None and self._cont.max_len >= needed_len:
            return self._cont
        max_len = self.engine_max_len or needed_len
        max_len = max(max_len, needed_len)
        ps = self.page_size
        max_len = -(-max_len // ps) * ps
        buckets = []
        b = ps
        while b < max_len:
            buckets.append(b)
            b *= 2
        buckets.append(max_len)
        self._cont = PagedContinuousEngine(
            self.model, num_slots=self.batch_size, max_len=max_len,
            sp=SamplingParams(eos_token_ids=(self.cfg.eos_token_id,),
                              pad_token_id=self.cfg.pad_token_id),
            attn_impl=self.attn_impl, prompt_buckets=tuple(buckets),
            page_size=ps, kv_quant=self.kv_quant, spec_decode=self.spec_decode)
        return self._cont

    def _run_continuous(self, loader, indices, gen_kwargs):
        """Continuous batching fed by the prefetch loader: instances are
        admitted as their host preprocessing completes (non-blocking poll)
        while active slots keep decoding."""
        sp = self._sampling(gen_kwargs)
        mnt = sp.max_new_tokens

        out: dict[int, str] = {}
        rid_to_idx: dict[int, int] = {}
        ready: list = []  # (prepared, idx) in schedule order
        pulled = 0
        n = len(indices)

        def pull_available():
            nonlocal pulled
            while pulled < n:
                item = loader.poll()
                if item is None:
                    break
                ready.append((item, indices[pulled]))
                pulled += 1

        def admit_ready() -> bool:
            """Admit ready instances; a burst goes through submit_batch, one
            batched prefill pass a bucket group, ViT embeds riding along."""
            if not ready:
                return False
            # + a decode window's margin, so a window never clamps
            needed = max(len(ids) + mnt + 1 + 2 * self.decode_steps
                         for (ids, _), _ in ready)
            eng = self._cont
            if eng is None or needed > eng.max_len:
                if eng is not None and eng.num_active:
                    return False  # grow the pool only once drained
                # grow geometrically, so ascending-cost admission does not
                # rebuild at every page-boundary crossing
                if eng is not None:
                    needed = max(needed, 2 * eng.max_len)
                eng = None  # drop every alias before allocating the new
                self._cont = None  # pool, so the old one is freed first
                eng = self._get_cont_engine(needed)
            free_slots = eng.num_slots - eng.num_active
            if free_slots <= 0:
                return False
            take = ready[:free_slots]
            items = []
            for (ids, feats), _idx in take:
                vision = None
                if feats:
                    vision = (self._vision_embeds(feats), [f.grid_thw for f in feats],
                              [f.second_per_grid_t for f in feats])
                items.append((list(ids), mnt, None, sp, None, vision))
            rids = eng.submit_batch(items)
            admitted = 0
            still_waiting = []
            for entry, rid in zip(take, rids):
                if rid is None:
                    still_waiting.append(entry)
                else:
                    rid_to_idx[rid] = entry[1]
                    admitted += 1
            ready[:free_slots] = still_waiting
            return admitted > 0

        done = 0
        eng = None
        while done < n:
            eng = None  # no stale alias across a possible engine rebuild
            pull_available()
            while admit_ready():
                pass
            eng = self._cont
            if eng is not None and eng.num_active:
                for rid, toks in eng.step(steps=self.decode_steps):
                    out[rid_to_idx[rid]] = self._apply_until(
                        self.tok.decode(toks, skip_special_tokens=True),
                        gen_kwargs)
                    done += 1
            elif not ready and pulled < n:
                # idle and nothing prepared: block on the next instance
                ready.append((next(loader), indices[pulled]))
                pulled += 1
        return out
