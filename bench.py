"""Benchmark driver: steady-state decode throughput on the local GPU.

Methodology mirrors the reference's render loop (jpeg_gpu.c:1228-1461):
repeated decode of one image with an explicit device sync before each
timestamp (their glFinish -> our block_until_ready), reporting
pixels/second.  The headline metric is device-pipeline throughput for the
1080p 4:2:0 config (BASELINE.json config #2), batched for steady state.
Device throughputs are slopes between two chain lengths of iterations
inside one jit (with a real data dependency), which cancels the fixed
dispatch cost.

Runs in one process and only on a GPU.  ``JAXJPEG_BENCH_FULL=1`` adds the
512 grayscale, 8K and corpus configs.  Prints exactly one JSON line.
"""

from __future__ import annotations

import functools
import json
import os
import queue
import sys
import threading
import time

import numpy as np


def _stage(msg, _t0=[None]):
    """Progress timestamps on stderr (stdout stays one JSON line)."""
    if _t0[0] is None:
        _t0[0] = time.perf_counter()
    print(
        f"[bench +{time.perf_counter() - _t0[0]:7.1f}s] {msg}",
        file=sys.stderr,
        flush=True,
    )


def _jpeg(h, w, subsampling="4:2:0", restart=0, seed=1, quality=85):
    from jaxjpeg.testing import corpus

    img = corpus.synthetic_rgb(h, w, seed=seed)
    if subsampling == "mono":
        img = img[..., 1].copy()
    return corpus.own_jpeg(
        img, subsampling=subsampling, quality=quality, restart_interval=restart
    ).data


def _best_time(fn, iters, *args, reps=3):
    """Best-of-reps wall time of fn(iters, *args); first call warms."""
    import jax.numpy as jnp

    it = jnp.int32(iters)
    int(fn(it, *args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        int(fn(it, *args))
        best = min(best, time.perf_counter() - t0)
    return best


def _slope(fn, k1, k2, *args):
    return (_best_time(fn, k2, *args) - _best_time(fn, k1, *args)) / (k2 - k1)


def _pipeline_mpix_s(hdr, coefs, qtables, upsample, batch, k1, k2):
    """coefs -> RGB throughput (Mpix/s) of a batched decode."""
    import jax
    import jax.numpy as jnp

    from jaxjpeg.engine import pipeline

    spec = pipeline.PipelineSpec.from_header(hdr, exact=True, upsample=upsample)

    @jax.jit
    def chained(iters, coefs, qtables):
        def body(_, carry):
            c0 = coefs[0] + (carry % 3).astype(jnp.int16)
            out = pipeline.decode_rgb.__wrapped__(spec, (c0,) + coefs[1:], qtables)
            return (jnp.sum(out.astype(jnp.uint32)) % 997 + carry).astype(
                jnp.uint32
            )

        return jax.lax.fori_loop(0, iters, body, jnp.uint32(0))

    sec = _slope(chained, k1, k2, coefs, qtables)
    return hdr.width * hdr.height * batch / 1e6 / sec


def _full_decode_mpix_s(h, w, subsampling, nbatch, k1, k2, upsample="nearest"):
    """Fully on-device bits -> RGB throughput (Mpix/s), R=1 streams."""
    import jax
    import jax.numpy as jnp

    from jaxjpeg.engine import pipeline
    from jaxjpeg.host import segments as seg_mod
    from jaxjpeg.host.parser import parse
    from jaxjpeg.ops import entropy_device as edev

    par = parse(_jpeg(h, w, subsampling, restart=1))
    hd = par.header
    sp = pipeline.PipelineSpec.from_header(hd, exact=True, upsample=upsample)
    pl = seg_mod.build_plan(par)
    s1 = np.asarray(pl.streams)
    st = jnp.asarray(np.concatenate([s1] * nbatch))
    rest = tuple(jnp.asarray(x) for x in pl.kernel_tables)
    gm = tuple((c.hsamp, c.vsamp) for c in hd.components)
    qts = tuple(
        jnp.asarray(hd.quant_for(c).values.astype(np.int32))
        for c in hd.components
    )

    @jax.jit
    def chained_full(iters, st, *rest):
        def body(_, carry):
            s = st ^ (carry % 2).astype(jnp.int32)
            out, err = edev.decode_segments_device(s, *rest)
            per_frame = out.reshape((nbatch, -1) + out.shape[1:])
            comps = edev.assemble_components(
                per_frame, pl.n_segments, pl.mcus_per_segment,
                hd.n_mcus, hd.nhmb, hd.nvmb, gm,
            )
            rgb = pipeline.decode_rgb.__wrapped__(sp, comps, qts)
            return (
                jnp.sum(rgb.astype(jnp.uint32)) % 997
                + jnp.sum(err) % 13 + carry
            ).astype(jnp.int32)
        return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

    sec = _slope(chained_full, k1, k2, st, *rest)
    return h * w * nbatch / 1e6 / sec


def _overlapped(one_frame, host_side, n_frames):
    """Best wall time of n_frames with host work for frame N+1 overlapped
    with the device decode of frame N (2-deep producer thread)."""
    import jax

    best = float("inf")
    for _ in range(2):
        q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            for _ in range(n_frames):
                q.put(host_side())

        t0 = time.perf_counter()
        th = threading.Thread(target=producer)
        th.start()
        outs = [one_frame(*q.get()) for _ in range(n_frames)]
        th.join()
        jax.block_until_ready(outs)
        best = min(best, time.perf_counter() - t0)
    return best, outs


def _per_frame_ms(fn, n_frames, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best / n_frames * 1e3


def _e2e_mpix_s(dat, n_frames=24):
    """Bytes -> pixels with the host's parse and plan in the measurement,
    overlapped with the device decode.  Restart-marker stream."""
    import jax
    import jax.numpy as jnp

    from jaxjpeg.engine import pipeline
    from jaxjpeg.host import segments as seg_mod
    from jaxjpeg.host.parser import parse
    from jaxjpeg.ops import entropy_device as edev

    par0 = parse(dat)
    hd = par0.header
    sp = pipeline.PipelineSpec.from_header(hd, exact=True)
    gm = tuple((c.hsamp, c.vsamp) for c in hd.components)
    qts = tuple(
        jnp.asarray(hd.quant_for(c).values.astype(np.int32))
        for c in hd.components
    )
    plan0 = seg_mod.build_plan(par0)
    # A pinned row width skips the sizing pass and keeps one program.
    plan_builder = functools.partial(seg_mod.build_plan, nw=plan0.nw)
    tables0 = tuple(jnp.asarray(x) for x in plan0.kernel_tables)

    @jax.jit
    def one_frame(st, *tables):
        out, err = edev.decode_segments_device(st, *tables)
        comps = edev.assemble_components(
            out, plan0.n_segments, plan0.mcus_per_segment, hd.n_mcus,
            hd.nhmb, hd.nvmb, gm,
        )
        return pipeline.decode_rgb.__wrapped__(sp, comps, qts), err

    def host_side():
        return (jnp.asarray(plan_builder(parse(dat)).streams),) + tables0

    jax.block_until_ready(one_frame(*host_side()))
    host_ms = _per_frame_ms(
        lambda: [plan_builder(parse(dat)) for _ in range(n_frames)], n_frames
    )
    upload_ms = _per_frame_ms(
        lambda: [host_side() for _ in range(n_frames)], n_frames
    )
    best, _ = _overlapped(one_frame, host_side, n_frames)
    mpx = hd.width * hd.height * n_frames / 1e6
    return mpx / best, plan0.streams.nbytes, host_ms, upload_ms


def _e2e_spec_mpix_s(dat, n_frames=12):
    """Bytes -> pixels of a stream without restart markers: the device
    index scan, realignment and decode in one program per frame."""
    import jax
    import jax.numpy as jnp

    from jaxjpeg.engine import device_entropy, pipeline
    from jaxjpeg.host import segments as seg_mod
    from jaxjpeg.host.parser import parse
    from jaxjpeg.ops import entropy_device as edev

    par0 = parse(dat)
    hd = par0.header
    sp = pipeline.PipelineSpec.from_header(hd, exact=True)
    gm = tuple((c.hsamp, c.vsamp) for c in hd.components)
    qts = tuple(
        jnp.asarray(hd.quant_for(c).values.astype(np.int32))
        for c in hd.components
    )
    plan0 = seg_mod.build_plan_no_dri(par0)  # serial scan once: true nw
    inp0 = seg_mod.build_spec_scan_input(par0, nw=plan0.nw)
    sb_pin = inp0.subseq_bytes

    @jax.jit
    def one_frame(*args):
        out, err, ok, _ = device_entropy._spec_decode_kernel_out.__wrapped__(
            *args, sb=sb_pin, n_mcus=inp0.n_mcus, nw=inp0.nw, spw=inp0.spw,
            nws=inp0.nws, t_last=inp0.t_last, max_rounds=16, interpret=None,
        )
        comps = edev.assemble_components(
            out, inp0.n_mcus, 1, hd.n_mcus, hd.nhmb, hd.nvmb, gm,
        )
        return pipeline.decode_rgb.__wrapped__(sp, comps, qts), err, ok

    tables0 = tuple(
        jnp.asarray(x)
        for x in (
            inp0.dcslot_of_c, inp0.acslot_of_c, inp0.comp_of_step,
            inp0.dc_slot_of_step, inp0.ac_slot_of_step, inp0.seg_meta,
            inp0.cbase, inp0.counts, inp0.symbols,
        )
    )

    def scan_input():
        return seg_mod.build_spec_scan_input(
            parse(dat), subseq_bytes=sb_pin, nw=plan0.nw
        )

    def host_side():
        inp = scan_input()
        return (
            jnp.asarray(inp.windows),
            jnp.asarray(np.array([inp.n_bits], np.int32)),
        ) + tables0

    _, _, ok = one_frame(*host_side())
    assert bool(ok), "device index scan did not converge on the bench image"
    host_ms = _per_frame_ms(
        lambda: [scan_input() for _ in range(n_frames)], n_frames
    )
    upload_ms = _per_frame_ms(
        lambda: [host_side() for _ in range(n_frames)], n_frames
    )
    best, outs = _overlapped(one_frame, host_side, n_frames)
    assert all(bool(o[2]) for o in outs)
    mpx = hd.width * hd.height * n_frames / 1e6
    return mpx / best, inp0.windows.nbytes, host_ms, upload_ms


def _corpus_metrics(n=64, hw=(256, 256)):
    """Corpus serving: with the RGB download, and device-resident
    sustained over 8 buckets (host work of bucket N+1 overlaps the device
    decode of bucket N through async dispatch)."""
    import jax

    from jaxjpeg.engine.batch import (
        decode_batch_device,
        decode_batch_device_resident,
    )

    datas = [
        _jpeg(*hw, restart=1, seed=100 + i, quality=75 + i % 20)
        for i in range(n)
    ]
    mpx = n * hw[0] * hw[1] / 1e6
    outs = decode_batch_device(datas)
    assert len(outs) == n and outs[0].shape == hw + (3,)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        decode_batch_device(datas)
        best = min(best, time.perf_counter() - t0)
    with_download = mpx / best
    rgb, err = decode_batch_device_resident(datas, check_errors=False)
    assert not np.asarray(err).any()
    n_reps = 8
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [
            decode_batch_device_resident(datas, check_errors=False)
            for _ in range(n_reps)
        ]
        jax.block_until_ready([o[0] for o in outs])
        best = min(best, time.perf_counter() - t0)
    return {
        "corpus_with_download_mpix_per_s": round(with_download, 1),
        "corpus_device_resident_mpix_per_s": round(n_reps * mpx / best, 1),
    }


def main() -> int:
    import jax
    import jax.numpy as jnp

    from jaxjpeg.utils.cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    from jaxjpeg.host import entropy_native
    from jaxjpeg.host.entropy import decode_scan
    from jaxjpeg.host.parser import parse

    height, width, batch = 1080, 1920, 8
    parsed = parse(_jpeg(height, width, seed=0))
    use_native = entropy_native.available()
    scan_decode = entropy_native.decode_scan if use_native else decode_scan
    result = scan_decode(parsed)  # warm (native .so build / LUTs)
    t0 = time.perf_counter()
    result = scan_decode(parsed)
    host_entropy_s = time.perf_counter() - t0
    hdr = parsed.header
    qtables = tuple(
        jnp.asarray(hdr.quant_for(c).values.astype(np.int32))
        for c in hdr.components
    )
    coefs = tuple(
        jnp.asarray(np.broadcast_to(c, (batch,) + c.shape).copy())
        for c in result.coefs
    )

    _stage("headline coefs->rgb 8x1080p")
    device_mpix_s = _pipeline_mpix_s(hdr, coefs, qtables, "nearest", batch, 20, 120)
    _stage("fancy parity coefs->rgb 8x1080p")
    fancy_mpix_s = _pipeline_mpix_s(hdr, coefs, qtables, "fancy", batch, 10, 60)
    _stage("full on-device 1080p")
    full_mpix_s = _full_decode_mpix_s(1080, 1920, "4:2:0", batch, 5, 35)
    _stage("e2e bytes->pixels, R=1")
    e2e, bits_bytes, e2e_host_ms, e2e_up_ms = _e2e_mpix_s(
        _jpeg(1080, 1920, restart=1)
    )
    _stage("e2e bytes->pixels, no restart markers")
    e2e_nodri, _, nodri_host_ms, nodri_up_ms = _e2e_spec_mpix_s(
        _jpeg(1080, 1920)
    )
    _stage("full on-device 4K 4:2:2")
    mpix4k = _full_decode_mpix_s(2160, 3840, "4:2:2", 2, 4, 16)

    extended = {}
    if os.environ.get("JAXJPEG_BENCH_FULL"):
        _stage("extended: corpus")
        extended.update(_corpus_metrics())
        _stage("extended: 512 grayscale full on-device")
        extended["full_512gray_device_decode_mpix_per_s"] = round(
            _full_decode_mpix_s(512, 512, "mono", 32, 10, 60), 1
        )
        _stage("extended: 8K full on-device")
        extended["full_8k420_device_decode_mpix_per_s"] = round(
            _full_decode_mpix_s(4320, 7680, "4:2:0", 1, 3, 9), 1
        )
        _stage("extended: 8K full on-device, fancy")
        extended["full_8k420_fancy_device_decode_mpix_per_s"] = round(
            _full_decode_mpix_s(4320, 7680, "4:2:0", 1, 3, 9, upsample="fancy"),
            1,
        )
    _stage("done")

    print(
        json.dumps(
            {
                "metric": "device_decode_1080p_420_mpix_per_s",
                "value": round(device_mpix_s, 1),
                "unit": "Mpix/s",
                "detail": {
                    "batch": batch,
                    "fancy_parity_mpix_per_s": round(fancy_mpix_s, 1),
                    "full_on_device_decode_mpix_per_s": round(full_mpix_s, 1),
                    "full_4k422_device_decode_mpix_per_s": round(mpix4k, 1),
                    "e2e_bytes_to_pixels_mpix_per_s": round(e2e, 1),
                    "e2e_no_dri_mpix_per_s": round(e2e_nodri, 1),
                    "e2e_host_ms_per_frame": round(e2e_host_ms, 2),
                    "e2e_host_upload_ms_per_frame": round(e2e_up_ms, 2),
                    "e2e_no_dri_host_ms_per_frame": round(nodri_host_ms, 2),
                    "e2e_no_dri_host_upload_ms_per_frame": round(
                        nodri_up_ms, 2
                    ),
                    # Bytes shipped per frame at the two serving cuts (the
                    # reference's img.packed variable, jpeg_gpu.c:803,1287).
                    "upload_bytes_coefs_frame": int(
                        sum(np.asarray(c).nbytes for c in result.coefs)
                    ),
                    "upload_bytes_bits_frame": int(bits_bytes),
                    "host_entropy_mpix_per_s": round(
                        width * height / 1e6 / host_entropy_s, 2
                    ),
                    "host_entropy_impl": "native" if use_native else "python",
                    "platform": devs[0].platform,
                    "device_kind": devs[0].device_kind,
                    "device_count": len(devs),
                    **extended,
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
