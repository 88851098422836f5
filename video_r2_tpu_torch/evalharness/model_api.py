"""Model adapters for the eval harness.

Port of ``video_r2_tpu/evalharness/model_api.py``; `LMM`, `FromLogModel`,
`StaticModel` and `uniform_subsample_indices` are copies, which
tests/test_torch_eval.py holds equal to the originals.

- `LMM` ABC (parity: eval/lmms-eval/lmms_eval/api/model.py `lmms`).
- `EngineModel`: the port's generation engines as the eval backend
  (evalharness/engine_backend.py; replaces the reference's
  models/qwen2_5_vl.py), over a model module already built on its device.
- `FromLogModel`: replays previously logged responses (models/from_log.py
  parity), the fake backend that lets task / metric code run with no model.
"""

from __future__ import annotations

import abc
import json
from pathlib import Path

import numpy as np

from .api import Instance, doc_hash


class LMM(abc.ABC):
    # Installed by the runner when a cache_dir is configured: backends that
    # batch internally SHOULD call cache_hook.add_partial(done_instances,
    # done_resps) after each engine batch so a mid-task crash only replays
    # the un-flushed tail (reference CacheHook, api/model.py; the runner
    # flushes anything left over after generate_until returns).
    cache_hook = None

    @abc.abstractmethod
    def generate_until(self, instances: list[Instance]) -> list[str]:
        ...

    def loglikelihood(self, instances: list[Instance],
                      continuations: list[str] | None = None
                      ) -> list[tuple[float, bool]]:
        """(log P(continuation | context), is_greedy) per request — the lmms
        ABC's second output type (api/model.py:29-50). Optional: none of the
        11 video benchmarks use it; EngineModel implements it."""
        raise TypeError(f"{type(self).__name__} does not score "
                        "loglikelihood requests")

    def generate_until_multi_round(self, instances: list[Instance]
                                   ) -> list[list[str]]:
        """Multi-turn generation (api/model.py generate_until_multi_round):
        inst.text is a LIST of per-round prompts; each round's context is
        the accumulated prompts + responses so far."""
        results = []
        for inst in instances:
            rounds = inst.text if isinstance(inst.text, list) else [inst.text]
            ctx, resps = "", []
            for r in rounds:
                one = Instance(inst.doc_id, inst.doc, ctx + r, inst.visuals,
                               dict(inst.gen_kwargs or {}))
                resp = self.generate_until([one])[0]
                resps.append(resp)
                ctx = ctx + r + resp
            results.append(resps)
        return results


def uniform_subsample_indices(n_frames: int, max_num_frames: int) -> list[int]:
    """Uniform subsample forcing the last frame (qwen2_5_vl.py:286-293)."""
    if n_frames <= max_num_frames:
        return list(range(n_frames))
    idx = np.linspace(0, n_frames - 1, max_num_frames).astype(int).tolist()
    if idx[-1] != n_frames - 1:
        idx[-1] = n_frames - 1
    return idx


class EngineModel(LMM):
    """Eval backend on the port's engines (batched `generate` or the paged
    continuous engine), on the model module's device. The JAX EngineModel's
    (params, cfg) pair is the module here, which carries its config."""

    def __init__(self, model, tokenizer, max_num_frames: int = 128,
                 max_pixels: int = 151200, min_pixels: int = 100352,
                 fps: float | None = None, batch_size: int = 8,
                 system_prompt: str = "You are a helpful assistant.",
                 attn_impl: str = "auto", seed: int = 0,
                 engine_mode: str = "batch", engine_max_len: int | None = None,
                 **backend_kwargs):
        from .engine_backend import EngineBackend

        self.backend = EngineBackend(
            model, tokenizer, max_num_frames=max_num_frames,
            max_pixels=max_pixels, min_pixels=min_pixels, fps=fps,
            batch_size=batch_size, system_prompt=system_prompt,
            attn_impl=attn_impl, seed=seed, engine_mode=engine_mode,
            engine_max_len=engine_max_len, **backend_kwargs)

    def generate_until(self, instances: list[Instance]) -> list[str]:
        self.backend.cache_hook = self.cache_hook
        return self.backend.generate_until(instances)

    def loglikelihood(self, instances: list[Instance],
                      continuations: list[str] | None = None
                      ) -> list[tuple[float, bool]]:
        return self.backend.loglikelihood(instances, continuations)


class FromLogModel(LMM):
    """Re-serves previously logged responses keyed by doc hash (falling back
    to doc_id order)."""

    def __init__(self, log_path: str | Path):
        self.by_hash: dict[str, str] = {}
        self.by_id: dict[int, str] = {}
        for line in open(log_path):
            if not line.strip():
                continue
            row = json.loads(line)
            resp = row.get("resps")
            if isinstance(resp, list):
                while isinstance(resp, list):
                    resp = resp[0] if resp else ""
            if "doc" in row:
                self.by_hash[doc_hash(row["doc"])] = resp
            if "doc_id" in row:
                self.by_id[int(row["doc_id"])] = resp

    def generate_until(self, instances: list[Instance]) -> list[str]:
        out = []
        for inst in instances:
            h = doc_hash(inst.doc)
            if h in self.by_hash:
                out.append(self.by_hash[h])
            elif inst.doc_id in self.by_id:
                out.append(self.by_id[inst.doc_id])
            else:
                raise KeyError(f"no logged response for doc_id={inst.doc_id}")
        return out


class StaticModel(LMM):
    """Fixed responses for tests."""

    def __init__(self, responses: list[str] | str):
        self.responses = responses

    def generate_until(self, instances: list[Instance]) -> list[str]:
        if isinstance(self.responses, str):
            return [self.responses] * len(instances)
        return [self.responses[i % len(self.responses)]
                for i in range(len(instances))]
