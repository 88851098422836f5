"""Judge server smoke test (train/serve_llm/test_vllm_client.py parity).

Port of ``video_r2_tpu/apps/test_judge.py``.

Usage:
  python -m video_r2_tpu_torch.apps.test_judge [--base http://localhost:8000/v1]
"""

from __future__ import annotations

import sys
import time

from ..rewards.judge import OpenAICompatClient


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    base = None
    if "--base" in argv:
        base = argv[argv.index("--base") + 1]
    client = OpenAICompatClient(base_url=base, timeout=30.0)
    t0 = time.time()
    out = client.chat(
        "You are a precise assistant.",
        "Reply with exactly the word READY.")
    dt = time.time() - t0
    print(f"judge at {client.base_url} responded in {dt:.2f}s: {out[:200]!r}")
    return out


if __name__ == "__main__":
    main()
