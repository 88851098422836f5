"""Serving entry point: the OpenAI-compatible judge server on the port.

Port of ``video_r2_tpu/apps/serve.py`` with its flags (``--port``,
``--continuous``, ``--paged``, ``--kv-quant``, ``--decode-window``,
``--max-len``, ``--spec-decode``, ``--prefill-chunk``), over the port's
`build_model` (seeded random weights on the card, ``--run.weight_quant``),
`build_tokenizer` and `build_mesh`. ``--device cpu`` builds the model on the
CPU instead (the kernels' plain versions); the default is the card, and a
missing card raises. ``--spec-decode K`` speculates with K n-gram drafts a
verify round and ``--prefill-chunk C`` prefills longer prompts a chunk of C
tokens a step (scripts/serve_judge.sh passes 8 and 2048).

Usage:
  python -m video_r2_tpu_torch.apps.serve --run.model_preset qwen3-moe-30b-a3b \\
      --run.weight_quant int8 --paged --kv-quant int8 --decode-window 8 --port 8000
"""

from __future__ import annotations

import sys

from ..config import AppConfig, parse_config, resolve_attn_impl
from ..engine.server import ChatEngine, serve
from .common import build_mesh, build_model, build_tokenizer, logger, setup_logging

# flag -> (ChatEngine keyword, type); --continuous and --paged take no value
_VALUE_FLAGS = {"--spec-decode": ("spec_decode", int),
                "--kv-quant": ("kv_quant", str),
                "--decode-window": ("decode_window", int),
                "--prefill-chunk": ("prefill_chunk_tokens", int),
                "--max-len": ("max_len", int)}


def parse_args(argv: list[str]) -> tuple[AppConfig, dict, int, str]:
    """(the AppConfig of the remaining --section.field flags, ChatEngine's
    serving keywords, the port, the device)."""
    opts = {"continuous": False, "engine_kind": "slots", "spec_decode": 0,
            "kv_quant": None, "decode_window": 1, "prefill_chunk_tokens": 0,
            "max_len": 4096}
    port, device, rest = 8000, "cuda", []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in _VALUE_FLAGS:
            key, typ = _VALUE_FLAGS[a]
            opts[key] = typ(argv[i + 1])
            i += 2
        elif a in ("--port", "--device"):
            if a == "--port":
                port = int(argv[i + 1])
            else:
                device = argv[i + 1]
            i += 2
        elif a == "--continuous":
            opts["continuous"] = True
            i += 1
        elif a == "--paged":
            opts.update(continuous=True, engine_kind="paged")
            i += 1
        else:
            rest.append(a)
            i += 1
    return parse_config(rest), opts, port, device


def build_engine(app: AppConfig, model, tok, mesh=None, **opts) -> ChatEngine:
    """The server's ChatEngine over a built model: `opts` are parse_args'
    serving keywords (and any other ChatEngine keyword, e.g.
    max_new_tokens); attention is run.attn_impl resolved on the model's
    device."""
    return ChatEngine(model, model.cfg, tok,
                      attn_impl=resolve_attn_impl(app.run, model.device), mesh=mesh,
                      **opts)


def main(argv=None):
    setup_logging()
    app, opts, port, device = parse_args(list(sys.argv[1:] if argv is None else argv))
    mesh = build_mesh(app)
    model = build_model(app, device)
    engine = build_engine(app, model, build_tokenizer(app), mesh=mesh, **opts)
    logger.info("serving OpenAI-compatible API on :%d (%s)", port, device)
    serve(engine, port=port)


if __name__ == "__main__":
    main()
