"""Re-bless the committed golden images (docs/images/*.png).

bench.py and chip_smoke.py gate every run against these goldens the way the
reference pins its output with README screenshots; neither of them writes a
golden. After a DELIBERATE visual change, run this on a GPU:

    python tools/bless_goldens.py           # cornell_conformance_golden.png
    python tools/bless_goldens.py --bench   # bench_golden.png, bench_tex1024.png

``--bench`` first runs the conformance checks without blessing (tiled ==
brute force, >= 40 dB vs the float64 oracle and the cornell golden) and
writes the bench goldens only if they pass. The bench goldens are the final
fly-through frames of the exact chip_smoke/bench program.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def bless_bench() -> None:
    import numpy as np

    import chip_smoke
    from arctic_tpu.models import pipeline

    bench.conformance_checks()
    bufs, frames, settings, config = chip_smoke.bench_scene()
    img, stats = pipeline.make_renderer_stats(config)(bufs, frames[-1], settings)
    pipeline.check_stats(stats)
    bench.check_golden(np.asarray(img), "bench_golden.png", "bench final frame", bless=True)
    timg = chip_smoke.textured_final_frame(frames, settings)
    bench.check_golden(timg, "bench_tex1024.png", "textured bench final frame", bless=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--bench", action="store_true",
        help="bless the bench goldens (after the conformance checks pass)",
    )
    args = ap.parse_args(argv)
    bench.require_gpu()
    if args.bench:
        bless_bench()
    else:
        bench.conformance_checks(bless=True)


if __name__ == "__main__":
    main()
