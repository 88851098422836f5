"""Post-hoc metric CLI: TAC / VAS / tree summaries over a predictions dir.

Port of ``video_r2_tpu/apps/postprocess.py`` (host only: the judge is an
HTTP endpoint, e.g. the port's apps/serve.py).

Parity surface: eval/scripts/tac/_run.sh + _run_all_benchmarks.py (TAC
dispatcher, skip-if-done, all_summaries.json), vas/_run.sh + evaluate_vas.py
(incl. --dry_run), and post_processing/summarize_{tac,vas}.py. The judge is
an OpenAI-compatible endpoint (our engine/server.py serving a judge model,
or any external one — serve_qwen3.sh role).

Usage:
  python -m video_r2_tpu_torch.apps.postprocess tac --predictions out/eval_think_128 \\
      --out out/tac [--judge-base http://localhost:8000/v1]
  python -m video_r2_tpu_torch.apps.postprocess vas --predictions ... --out out/vas \\
      [--dry-run]
  python -m video_r2_tpu_torch.apps.postprocess summarize --tac out/tac --vas out/vas
  python -m video_r2_tpu_torch.apps.postprocess vsibench --samples s.jsonl --out d.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

from ..evalharness.postprocess import (
    postprocess_vsibench_row,
    run_all_tac,
    run_all_vas,
    summarize_tac_tree,
    summarize_vas_tree,
)
from ..rewards.judge import OpenAICompatClient
from .common import logger, setup_logging


def _judge(args):
    return OpenAICompatClient(base_url=args.judge_base, model=args.judge_model,
                              timeout=args.judge_timeout)


def main(argv=None):
    setup_logging()
    ap = argparse.ArgumentParser(prog="postprocess")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_judge(p):
        p.add_argument("--judge-base", default=None,
                       help="OpenAI-compatible base URL (default env "
                            "OPENAI_API_BASE)")
        p.add_argument("--judge-model", default=None)
        p.add_argument("--judge-timeout", type=float, default=60.0)

    p = sub.add_parser("tac", help="Think-Answer Consistency over all "
                                   "discovered *samples*.jsonl")
    p.add_argument("--predictions", required=True)
    p.add_argument("--out", required=True)
    add_judge(p)

    p = sub.add_parser("vas", help="Video Attention Score over all "
                                   "discovered *samples*.jsonl")
    p.add_argument("--predictions", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dry-run", action="store_true",
                   help="print the execution plan, never contact the judge")
    add_judge(p)

    p = sub.add_parser("summarize", help="aggregate summary trees "
                                         "(latest-wins + consistency mixer)")
    p.add_argument("--tac", default=None)
    p.add_argument("--vas", default=None)

    p = sub.add_parser("vsibench", help="normalize free-form vsibench "
                                        "predictions (MCA letters / NA "
                                        "numbers, judge-assisted)")
    p.add_argument("--samples", required=True)
    p.add_argument("--out", required=True)
    add_judge(p)

    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if args.cmd == "tac":
        out = run_all_tac(args.predictions, _judge(args), args.out)
        logger.info("TAC: %d benchmarks -> %s/all_summaries.json",
                    len(out), args.out)
        return out
    if args.cmd == "vas":
        out = run_all_vas(args.predictions, _judge(args), args.out,
                          dry_run=args.dry_run)
        if args.dry_run:
            print(json.dumps(out, indent=2))
        else:
            logger.info("VAS: %d benchmarks -> %s/vas_summaries.json",
                        len(out), args.out)
        return out
    if args.cmd == "summarize":
        result = {}
        if args.tac:
            result["tac"] = summarize_tac_tree(args.tac)
        if args.vas:
            result["vas"] = summarize_vas_tree(args.vas)
        print(json.dumps(result, indent=2))
        return result
    if args.cmd == "vsibench":
        judge = _judge(args)
        with open(args.samples) as f, open(args.out, "w") as g:
            n = 0
            for line in f:
                if not line.strip():
                    continue
                row = postprocess_vsibench_row(json.loads(line), judge=judge)
                g.write(json.dumps(row, default=str) + "\n")
                n += 1
        logger.info("vsibench: %d rows -> %s", n, args.out)
        return n


if __name__ == "__main__":
    main()
