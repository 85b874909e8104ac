#!/usr/bin/env python3
"""Smoke check of the decoder on one GPU, through the entry points users call.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --devices 4   # only the multi-card paths, on 4 GPUs

Inputs are generated from seeds by the repo's own encoder
(``testing/encoder.py``) and checked against the repo's host decoders
(``HostDecoder``, the native entropy decoder), whose agreement with
libjpeg-turbo the CPU tests establish.  Phases:

* pixels -- ``decode`` at every stage cut (rgb both upsample modes, yuv,
  dct, quant) bit-identical to the host, for the BASELINE sizes and all
  six subsampling modes at odd sizes; the float path within PSNR > 45 dB
  and max |diff| <= 4 of the exact path; the float IDCT within the
  IEEE-1180 bounds.
* entropy -- ``entropy="device"`` coefficients bit-identical to the
  native host decoder at R=1, R=8 and without restart markers (device
  index scan), with no fallback to the host.
* pack_corpus -- ``upload="pack"``; ``decode_batch`` with host and device
  entropy and ``decode_batch_device_resident`` on a 64-image 1080p bucket
  with per-image optimised tables, all bit-identical to the host.
* kernel_vs_plain -- each Triton kernel against its plain jax.numpy
  version for the whole bits->RGB decode (median of 7 after warm-up); the
  pixel stage's bytes/s beside a plain device copy; memory analysis of
  the 8K and corpus programs.

Any failed phase makes the exit code non-zero.  The last line of stdout is
one JSON object naming the device.  Without a GPU the script refuses to
run.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import functools
import json
import statistics
import subprocess
import sys
import time
import traceback

MODES = ("mono", "4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1")
# BASELINE.json's configurations: (name, height, width, subsampling).
SIZES = (
    ("512 gray", 512, 512, "mono"),
    ("1080p 4:2:0", 1080, 1920, "4:2:0"),
    ("4K 4:2:2", 2160, 3840, "4:2:2"),
    ("8K 4:2:0", 4320, 7680, "4:2:0"),
)
ODD_SIZES = ((17, 31), (9, 1000))
ENTROPY_SIZES = SIZES[1:]
RESTARTS = (1, 8, 0)
CORPUS = (64, 1080, 1920)      # images, height, width (4:2:0, R=1)
TIMING_REPS = 7
# Threads for independent cases: XLA compiles and numpy release the GIL.
WORKERS = 8


class Report:
    """Records each check; a phase that raises is a failed phase."""

    def __init__(self):
        self.failed = []

    def check(self, name, ok, detail=""):
        print(f"  [{'ok' if ok else 'FAIL'}] {name} {detail}".rstrip(), flush=True)
        if not ok:
            self.failed.append(name)

    def run(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
        print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def _parallel(fn, items):
    """fn over items on a thread pool; results in order, errors raised."""
    with cf.ThreadPoolExecutor(WORKERS) as ex:
        return list(ex.map(fn, items))


@functools.lru_cache(maxsize=4)
def _image(h, w, seed):
    from jaxjpeg.testing import corpus

    return corpus.synthetic_rgb(h, w, seed=seed)


@functools.lru_cache(maxsize=None)
def make_jpeg(h, w, mode, restart=0, seed=0, quality=85):
    """A seeded test image encoded by the repo's encoder (cached)."""
    from jaxjpeg.testing import corpus

    img = _image(h, w, seed)
    if mode == "mono":
        img = img[..., 1].copy()
    return corpus.own_jpeg(
        img, subsampling=mode, quality=quality, restart_interval=restart
    ).data


def corpus_jpegs(n, h, w):
    """n 4:2:0 R=1 images with per-image optimised tables: 8 contents
    at n/8 qualities each."""
    return _parallel(
        lambda i: make_jpeg(h, w, "4:2:0", restart=1, seed=100 + i % 8,
                            quality=60 + 5 * (i // 8)),
        range(n),
    )


def _equal(a, b):
    return a.shape == b.shape and bool((a == b).all())


def _median_time(fn, *args, reps=TIMING_REPS):
    """Median wall time of fn(*args) after one warm-up call, each call
    ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# ------------------------------------------------------------------ phases
def _pixel_case(case):
    """Checks (name, ok, detail) of one size: every stage cut vs the host."""
    import numpy as np

    import jaxjpeg as jt
    from jaxjpeg.engine.decoder import HostDecoder
    from jaxjpeg.testing.oracle import psnr

    name, h, w, mode = case
    data = make_jpeg(h, w, mode, seed=h + w)
    out = []
    for ups in ("nearest", "fancy"):
        ref = HostDecoder(data, upsample=ups).decode("rgb")
        got = jt.decode(data, impl="device", upsample=ups)
        out.append((f"{name} rgb {ups}", _equal(np.asarray(got), ref), ""))
    for stage in ("yuv", "dct", "quant"):
        ref = HostDecoder(data).decode(stage)
        got = jt.decode(data, out=stage, impl="device")
        a = ref.planes if stage == "yuv" else ref.coefs
        b = got.planes if stage == "yuv" else got.coefs
        ok = len(a) == len(b) and all(
            _equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b)
        )
        out.append((f"{name} {stage}", ok, ""))
    exact = jt.decode(data, impl="device")
    fast = jt.decode(data, impl="device", exact=False)
    diff = int(np.abs(exact.astype(np.int32) - fast.astype(np.int32)).max())
    p = psnr(exact, fast)
    out.append((f"{name} float path", p > 45 and diff <= 4,
                f"psnr={p:.2f} dB max|diff|={diff}"))
    return out


def phase_pixels(rep, sizes=SIZES, odd_sizes=ODD_SIZES, ieee_blocks=10000):
    """Host entropy, device pixels: every stage cut bit-exact vs the host."""
    cases = list(sizes)
    cases += [(f"{h}x{w} {m}", h, w, m) for h, w in odd_sizes for m in MODES]
    for checks in _parallel(_pixel_case, cases):
        for check in checks:
            rep.check(*check)
    _check_ieee1180(rep, ieee_blocks)


def _check_ieee1180(rep, n):
    """The float IDCT on the device within the IEEE-1180 bounds."""
    import jax.numpy as jnp
    import numpy as np

    from jaxjpeg.ops import idct as idct_ops
    from jaxjpeg.testing.encoder import _M
    from jaxjpeg.testing.oracle import idct8x8_float64

    for lo, hi in ((-256, 255), (-5, 5), (-300, 300)):
        rng = np.random.default_rng(lo + 1000)
        pix = rng.integers(lo, hi + 1, size=(n, 8, 8)).astype(np.float64)
        coefs = np.einsum("ui,nij,vj->nuv", _M, pix, _M)
        coefs = np.clip(np.round(coefs), -2048, 2047).astype(np.int32)
        ref = np.clip(np.round(idct8x8_float64(coefs)), -256, 255)
        got = np.asarray(idct_ops.idct8x8(jnp.asarray(coefs)))
        err = np.clip(np.round(got), -256, 255) - ref
        ok = (
            np.abs(err).max() <= 1
            and (err ** 2).mean() <= 0.02
            and (err ** 2).mean(axis=0).max() <= 0.06
            and abs(err.mean()) <= 0.0015
        )
        rep.check(f"IEEE-1180 float idct [{lo}, {hi}]", ok,
                  f"peak={np.abs(err).max():.0f} mse={(err ** 2).mean():.4f}")


def _entropy_case(case):
    import numpy as np

    import jaxjpeg as jt
    from jaxjpeg.engine import device_entropy
    from jaxjpeg.host import entropy_native
    from jaxjpeg.host.parser import parse

    name, h, w, mode, r = case
    data = make_jpeg(h, w, mode, restart=r, seed=h + w)
    parsed = parse(data)
    ref = entropy_native.decode_scan(parsed)
    res = device_entropy.entropy_decode_device(parsed)
    ok = all(_equal(np.asarray(a), b) for a, b in zip(res.coefs, ref.coefs))
    # Without restart markers the device index scan must have run.
    scanned = r > 0 or res.specsync_stats is not None
    out = [(f"{name} R={r} coefficients", ok and scanned,
            f"index scan (rounds, MCUs)={res.specsync_stats}")]
    if h == 1080:
        got = jt.decode(data, impl="device", entropy="device")
        out.append((f"{name} R={r} rgb via decode()",
                    _equal(got, jt.decode(data, impl="host")), ""))
    return out


def phase_entropy(rep, sizes=ENTROPY_SIZES, restarts=RESTARTS):
    """entropy="device": coefficients bit-exact vs the native host
    decoder, no fallback; R=0 must go through the device index scan."""
    from jaxjpeg.engine import device_entropy

    before = sum(device_entropy.FALLBACKS.values())
    cases = [(name, h, w, mode, r) for name, h, w, mode in sizes for r in restarts]
    for checks in _parallel(_entropy_case, cases):
        for check in checks:
            rep.check(*check)
    falls = sum(device_entropy.FALLBACKS.values()) - before
    rep.check("entropy: no fallback to the host", falls == 0,
              f"{dict(device_entropy.FALLBACKS)}")


def phase_pack_corpus(rep, pack_size=(1080, 1920), corpus=CORPUS):
    """upload="pack" and the corpus paths, bit-exact vs the host."""
    import numpy as np

    import jaxjpeg as jt
    from jaxjpeg.engine import batch, device_entropy
    from jaxjpeg.engine.decoder import HostDecoder

    h, w = pack_size
    data = make_jpeg(h, w, "4:2:0", seed=h + w)
    got = jt.decode(data, impl="device", upload="pack")
    rep.check(f"{h}x{w} upload=pack rgb", _equal(got, jt.decode(data, impl="host")))

    n, ch, cw = corpus
    datas = corpus_jpegs(n, ch, cw)
    ref = _parallel(lambda d: HostDecoder(d).decode("rgb"), datas)
    before = sum(device_entropy.FALLBACKS.values())
    outs = batch.decode_batch(datas, entropy="host")
    rep.check(f"corpus {n}x{ch}x{cw} decode_batch host",
              all(_equal(a, b) for a, b in zip(outs, ref)))
    outs = batch.decode_batch(datas, entropy="device")
    rep.check(f"corpus {n}x{ch}x{cw} decode_batch device",
              all(_equal(a, b) for a, b in zip(outs, ref)))
    rgb, err = batch.decode_batch_device_resident(datas)
    rgb = np.asarray(rgb)
    rep.check(f"corpus {n}x{ch}x{cw} decode_batch_device_resident",
              all(_equal(rgb[i], ref[i]) for i in range(n))
              and not np.asarray(err).any())
    falls = sum(device_entropy.FALLBACKS.values()) - before
    rep.check("corpus no fallback", falls == 0, f"fallbacks={falls}")


def _restart_program(parsed, upsample="nearest"):
    """(fn, args): jitted bits->RGB of a restart-marker stream."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jaxjpeg.engine.pipeline import PipelineSpec, decode_rgb
    from jaxjpeg.host.segments import build_plan
    from jaxjpeg.ops import entropy_device

    hdr = parsed.header
    plan = build_plan(parsed)
    spec = PipelineSpec.from_header(hdr, upsample=upsample)
    geom = tuple((hdr.components[i].hsamp, hdr.components[i].vsamp)
                 for i in hdr.scan.comp_idx)
    qts = tuple(jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
                for c in hdr.components)

    @jax.jit
    def bits_to_rgb(streams, *tables):
        out, err = entropy_device.decode_segments_device(streams, *tables)
        comps = entropy_device.assemble_components(
            out, plan.n_segments, plan.mcus_per_segment, hdr.n_mcus,
            hdr.nhmb, hdr.nvmb, geom, hdr.scan.comp_idx,
        )
        return decode_rgb.__wrapped__(spec, comps, qts), err

    args = (jnp.asarray(plan.streams),) + tuple(
        jnp.asarray(x) for x in plan.kernel_tables
    )
    return bits_to_rgb, args


def _scan_program(parsed):
    """(fn, args): jitted bits->RGB of a stream without restart markers,
    through the device index scan."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jaxjpeg.engine import device_entropy
    from jaxjpeg.engine.pipeline import PipelineSpec, decode_rgb
    from jaxjpeg.host.segments import build_spec_scan_input
    from jaxjpeg.ops import entropy_device

    hdr = parsed.header
    inp = build_spec_scan_input(parsed)
    spec = PipelineSpec.from_header(hdr)
    geom = tuple((hdr.components[i].hsamp, hdr.components[i].vsamp)
                 for i in hdr.scan.comp_idx)
    qts = tuple(jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
                for c in hdr.components)

    @jax.jit
    def bits_to_rgb(*args):
        out, err, ok, _ = device_entropy._spec_decode_kernel_out.__wrapped__(
            *args, sb=inp.subseq_bytes, n_mcus=inp.n_mcus, nw=inp.nw,
            spw=inp.spw, nws=inp.nws, t_last=inp.t_last, max_rounds=16,
            interpret=None,
        )
        comps = entropy_device.assemble_components(
            out, hdr.n_mcus, 1, hdr.n_mcus, hdr.nhmb, hdr.nvmb, geom,
            hdr.scan.comp_idx,
        )
        return decode_rgb.__wrapped__(spec, comps, qts), err, ok

    args = tuple(jnp.asarray(x) for x in (
        inp.windows, np.array([inp.n_bits], np.int32), inp.dcslot_of_c,
        inp.acslot_of_c, inp.comp_of_step, inp.dc_slot_of_step,
        inp.ac_slot_of_step, inp.seg_meta, inp.cbase, inp.counts,
        inp.symbols,
    ))
    return bits_to_rgb, args


def phase_kernel_vs_plain(rep, sizes=ENTROPY_SIZES[:2], restarts=RESTARTS):
    """Each Triton kernel against its plain version (whole bits->RGB), the
    pixel stage's bytes/s beside a plain copy, and program memory."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jaxjpeg.engine import batch
    from jaxjpeg.engine.pipeline import PipelineSpec, decode_rgb
    from jaxjpeg.host import entropy_native
    from jaxjpeg.host.parser import parse
    from jaxjpeg.ops import route

    # Trace each program on both routes (the route is global state), then
    # compile them all concurrently, then time them one at a time.
    progs = []
    for name, h, w, mode in sizes:
        for r in restarts:
            parsed = parse(make_jpeg(h, w, mode, restart=r, seed=h + w))
            build, op = ((_restart_program, "entropy_decode") if r
                         else (_scan_program, "index_scan"))
            for how in (route.KERNEL, route.PLAIN):
                with route.forced(how, op=op):
                    fn, args = build(parsed)
                    progs.append((f"{name} R={r}", op, how, h * w / 1e6,
                                  fn.lower(*args), args))
    compiled = _parallel(lambda p: p[4].compile(), progs)
    results = {}
    for (label, op, how, mpix, _, args), exe in zip(progs, compiled):
        t = _median_time(exe, *args)
        results.setdefault((label, op, mpix), {})[how] = (
            t, [np.asarray(x) for x in exe(*args)]
        )
    for (label, op, mpix), by in results.items():
        (k, ko), (p, po) = by[route.KERNEL], by[route.PLAIN]
        rep.check(
            f"{label} bits->rgb: {op} kernel {k * 1e3:.3f} ms "
            f"({mpix / k:.1f} Mpix/s), plain {p * 1e3:.3f} ms "
            f"({mpix / p:.1f} Mpix/s), kernel/plain speedup {p / k:.2f}x",
            all(_equal(a, b) for a, b in zip(ko, po)), "(same output)",
        )

    # Pixel stage (coefficients -> RGB) against a plain copy of its bytes.
    for label, h, w, n, ups in (("8x1080p 4:2:0", 1080, 1920, 8, "nearest"),
                                ("8K 4:2:0 fancy", 4320, 7680, 1, "fancy")):
        parsed = parse(make_jpeg(h, w, "4:2:0", seed=h + w))
        hdr = parsed.header
        spec = PipelineSpec.from_header(hdr, upsample=ups)
        coefs = tuple(
            jnp.asarray(np.broadcast_to(c, (n,) + c.shape).copy())
            for c in entropy_native.decode_scan(parsed).coefs
        )
        qts = tuple(jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
                    for c in hdr.components)
        t_pix = _median_time(decode_rgb, spec, coefs, qts)
        nbytes = sum(c.nbytes for c in coefs) + n * h * w * 3
        # The copy reads and writes nbytes / 2 each.
        src = jnp.zeros((nbytes // 8,), jnp.int32)
        t_copy = _median_time(jax.jit(lambda x: x + 1), src)
        rep.check(
            f"{label} decode_rgb: {t_pix * 1e3:.3f} ms, "
            f"{nbytes / t_pix / 1e9:.1f} GB/s (int16 in + u8 out); "
            f"plain copy of the same bytes {t_copy * 1e3:.3f} ms, "
            f"{nbytes / t_copy / 1e9:.1f} GB/s; share {t_copy / t_pix:.2f}",
            True,
        )

    # Memory of the 8K and corpus programs.
    parsed = parse(make_jpeg(4320, 7680, "4:2:0", restart=1, seed=4320 + 7680))
    fn, args = _restart_program(parsed)
    mem = fn.lower(*args).compile().memory_analysis()
    rep.check(f"8K 4:2:0 R=1 bits->rgb memory: {mem}", True)
    n, ch, cw = CORPUS
    fn, args = batch.bucket_program(corpus_jpegs(n, ch, cw))
    rep.check(f"corpus {n}x{ch}x{cw} program memory: "
              f"{fn.lower(*args).compile().memory_analysis()}", True)


def phase_devices4(rep, batch_hw=(1080, 1920), n_images=8, big_hw=(4320, 7680)):
    """The multi-card paths, each bit-exact against the one-card decode."""
    import jax
    import numpy as np

    from jaxjpeg.engine import batch, device_entropy
    from jaxjpeg.host.parser import parse
    from jaxjpeg.parallel.mesh import make_mesh

    datas = [make_jpeg(*batch_hw, "4:2:0", restart=1, seed=500 + i)
             for i in range(n_images)]
    for entropy in ("host", "device"):
        one = batch.decode_batch(datas, entropy=entropy)
        for data_n, space in ((4, 1), (2, 2)):
            mesh = make_mesh(4, space=space)
            got = batch.decode_batch(datas, entropy=entropy, mesh=mesh)
            rep.check(f"decode_batch entropy={entropy} mesh=(data={data_n}, "
                      f"space={space})",
                      all(_equal(a, b) for a, b in zip(got, one)))
    # 8K 4:2:0 has 270 chroma block rows: space=4 does not divide them, so
    # the space axis is 2 here.
    mesh = make_mesh(4, space=2)
    for r in (1, 0):
        parsed = parse(make_jpeg(*big_hw, "4:2:0", restart=r, seed=600))
        before = sum(device_entropy.FALLBACKS.values())
        one = np.asarray(device_entropy.decode_image_device(parsed))
        got = device_entropy.decode_image_device_sharded(parsed, mesh)
        falls = sum(device_entropy.FALLBACKS.values()) - before
        rep.check(f"decode_image_device_sharded {big_hw} 4:2:0 R={r} "
                  f"mesh=(data=2, space=2)", _equal(got, one) and falls == 0,
                  f"fallbacks={falls}")
    for d in jax.devices()[:4]:
        stats = d.memory_stats()  # None where the platform keeps none
        peak = stats.get("peak_bytes_in_use") if stats else None
        rep.check(f"{d} peak_bytes_in_use={peak}",
                  bool(peak) or d.platform != "gpu")


# ---------------------------------------------------------------- driver
def device_line():
    """nvidia-smi's name and power limit, JAX's device kind and count, and
    the compile cache directory."""
    import jax

    from jaxjpeg.host import entropy_native
    from jaxjpeg.utils.cache import enable_compile_cache

    cache = enable_compile_cache()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    for line in smi.splitlines():
        print(line, flush=True)
    devs = jax.devices()
    print(f"jax {jax.__version__}: {devs[0].platform} {devs[0].device_kind} "
          f"x{len(devs)}; compile cache {cache}; native host decoder "
          f"{'available' if entropy_native.available() else 'UNAVAILABLE'}",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card paths, on 4 GPUs")
    ap.add_argument("--phases", default="",
                    help="comma-separated subset of the one-card phases")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's platform is {devs[0].platform!r}; "
              "this check runs only on a GPU", file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: --devices {args.devices} needs {args.devices} "
              f"GPUs, found {len(devs)}", file=sys.stderr)
        return 2
    device_line()
    rep = Report()
    if args.devices == 4:
        rep.run("devices4", phase_devices4)
    else:
        phases = {
            "pixels": phase_pixels,
            "entropy": phase_entropy,
            "pack_corpus": phase_pack_corpus,
            "kernel_vs_plain": phase_kernel_vs_plain,
        }
        chosen = [p for p in args.phases.split(",") if p] or list(phases)
        for name in chosen:
            rep.run(name, phases[name])
    if rep.failed:
        print(f"chip_smoke: FAILED: {rep.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
