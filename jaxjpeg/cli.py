"""Command-line driver (the reference's app layer, jpeg_gpu.c:473-700).

Same control surface as the reference minus the GL window: pick a decoder
implementation and an output stage, print headers, dump decoded data for
differential testing, or run the repeated-decode benchmark loop (the
render loop's role, jpeg_gpu.c:1228-1461, with cpu/device time split).

    python -m jaxjpeg image.jpg                   # decode, report
    python -m jaxjpeg -H image.jpg                # header only
    python -m jaxjpeg -d -o quant image.jpg       # dump stage data
    python -m jaxjpeg -b 50 image.jpg             # benchmark loop
    python -m jaxjpeg --save out.png image.jpg    # decode to PNG
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from jaxjpeg.engine.decoder import _BACKENDS, get_decoder
from jaxjpeg.engine.stages import OutputStage
from jaxjpeg.errors import JpegError
from jaxjpeg.utils import logging as log_util


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jaxjpeg",
        description="baseline JPEG decoder on an accelerator (JAX)",
    )
    p.add_argument("file", help="JPEG file to decode")
    p.add_argument(
        "-i", "--impl", default="device", choices=sorted(_BACKENDS),
        help="decoder backend (default: device)",
    )
    p.add_argument(
        "-o", "--out", default="rgb",
        choices=[s.value for s in OutputStage],
        help="pipeline output stage (default: rgb)",
    )
    p.add_argument(
        "-e", "--entropy", default="auto",
        choices=["auto", "native", "python", "device"],
        help="entropy decoder: host C++ (native), host python, or on the device",
    )
    p.add_argument("-H", "--header", action="store_true", help="print header and exit")
    p.add_argument("-d", "--dump", action="store_true", help="dump decoded data")
    p.add_argument(
        "-b", "--bench", type=int, metavar="N", default=0,
        help="benchmark: decode N times, report FPS + time split",
    )
    p.add_argument(
        "--fast", action="store_true",
        help="float (AAN-semantics) path: IEEE-1180-accurate, not bit-exact",
    )
    p.add_argument(
        "--fancy", action="store_true",
        help="fancy (triangle) chroma upsampling: bit-exact vs libjpeg RGB",
    )
    p.add_argument(
        "--upload", default="coefs", choices=["coefs", "pack"],
        help="host->device payload for host-entropy modes (default: coefs)",
    )
    p.add_argument("--no-validate", action="store_true", help="skip bitstream validation")
    # The reference's ablation switches (jpeg_gpu.c:481-484, 560-567) as
    # explicit aliases over the --impl/--entropy axes:
    p.add_argument(
        "--no-gpu", action="store_true",
        help="decode entirely on the host (alias for --impl host; the "
        "reference's --no-gpu)",
    )
    p.add_argument(
        "--no-cpu", action="store_true",
        help="host does no Huffman work: entropy decode (and for DRI-less "
        "streams the index scan) runs on the device (alias for --impl device "
        "--entropy device; the reference's --no-cpu)",
    )
    p.add_argument(
        "--on-error", default="raise", choices=["raise", "zero"],
        help="device-entropy error policy: abort, or salvage (corrupt "
        "restart segments decode as flat gray)",
    )
    p.add_argument("--save", metavar="PNG", help="save RGB output as PNG")
    p.add_argument(
        "--profile", metavar="DIR",
        help="capture a jax.profiler trace of the decode into DIR "
        "(view with tensorboard / xprof)",
    )
    return p


def _dump(result, stage: OutputStage) -> None:
    """Print decoded data for differential diffing (cf. jpeg_gpu.c:641-700)."""
    if stage in (OutputStage.QUANT, OutputStage.DCT):
        for ci, c in enumerate(result.coefs):
            vb, hb = c.shape[:2]
            print(f"plane {ci}: {hb}x{vb} blocks")
            flat = c.transpose(0, 2, 1, 3).reshape(vb * 8, hb * 8)
            for row in flat:
                print(" ".join(str(int(v)) for v in row))
    elif stage == OutputStage.PACK:
        print(f"packed entries: {len(result.pack)}")
        for ci, idx in enumerate(result.index):
            vb, hb = idx.shape
            print(f"plane {ci}: {hb}x{vb} blocks")
            for row in idx:
                print(" ".join(str(int(v)) for v in row))
        print(" ".join(f"{int(v):04x}" for v in result.pack))
    elif stage == OutputStage.YUV:
        for ci, plane in enumerate(result.planes):
            h, w = plane.shape
            print(f"plane {ci}: {w}x{h}")
            for row in plane:
                print(" ".join(str(int(v)) for v in row))
    else:
        h, w = result.shape[:2]
        print(f"rgb: {w}x{h}")
        for row in result.reshape(h, w * 3):
            print(" ".join(str(int(v)) for v in row))


def main(argv=None) -> int:
    log_util.init()
    args = build_parser().parse_args(argv)
    if args.no_gpu and args.no_cpu:
        print("error: --no-gpu and --no-cpu are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.no_gpu:
        args.impl = "host"
    if args.no_cpu:
        args.impl = "device"
        args.entropy = "device"
    stage = OutputStage(args.out)
    try:
        with open(args.file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    kwargs = {"validate": not args.no_validate}
    if args.impl in ("device",):
        kwargs["exact"] = not args.fast
        kwargs["entropy"] = args.entropy
        kwargs["upload"] = args.upload
        kwargs["upsample"] = "fancy" if args.fancy else "nearest"
        kwargs["on_error"] = args.on_error
    elif args.impl in ("host", "xjpeg"):
        kwargs["entropy"] = args.entropy
        kwargs["upsample"] = "fancy" if args.fancy else "nearest"
    try:
        dec = get_decoder(data, impl=args.impl, **kwargs)
        header = dec.decode_header()
        if args.header:
            print(header.describe())
            return 0

        if args.bench:
            # Repeated decode loop with host/total split (cf. the
            # reference's title-bar metrics, jpeg_gpu.c:1444-1458).
            dec.decode(stage)  # warm-up / compile
            t0 = time.perf_counter()
            host_s = 0.0
            for _ in range(args.bench):
                dec.reset()
                t1 = time.perf_counter()
                dec.decode_header()
                dec.host_entropy(stage)  # the exact host work decode() uses
                host_s += time.perf_counter() - t1
                dec.decode(stage)
            total = time.perf_counter() - t0
            mpix = header.width * header.height * args.bench / 1e6
            # Bytes shipped per frame at this stage cut -- the reference's
            # central experiment variable (img.packed, jpeg_gpu.c:803,1287).
            io = dec.io_bytes(stage)
            print(
                f"{args.bench / total:.1f} FPS "
                f"(host {host_s / args.bench * 1e3:.3f} ms, "
                f"total {total / args.bench * 1e3:.3f} ms/frame, "
                f"{mpix / total:.1f} Mpix/s, impl={args.impl}, "
                f"out={stage.value}, entropy={args.entropy}, "
                f"upload={io['upload']}B/frame ({io['payload']}), "
                f"download={io['download']}B, tables={io['tables']}B)"
            )
            return 0

        if args.profile:
            import jax

            dec.decode(stage)  # warm-up so the trace holds steady state
            dec.reset()
            with jax.profiler.trace(args.profile):
                result = dec.decode(stage)
            print(f"profiler trace written to {args.profile}")
        else:
            result = dec.decode(stage)
        if args.dump:
            _dump(result, stage)
        elif stage == OutputStage.RGB:
            h, w = result.shape[:2]
            print(f"decoded {w}x{h} rgb ({args.impl}, {header.subsampling.value})")
            if args.save:
                from PIL import Image

                Image.fromarray(np.asarray(result)).save(args.save)
                print(f"saved {args.save}")
        else:
            print(f"decoded stage {stage.value} ({args.impl})")
        return 0
    except JpegError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
