"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases pass at tiny sizes (the plain route stands in for the kernels)."""

import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu_platform():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert proc.stdout.strip() == ""


def _run(phase, *args):
    rep = chip_smoke.Report()
    rep.run(phase.__name__, phase, *args)
    return rep.failed


def test_phase_pixels_tiny():
    assert _run(
        chip_smoke.phase_pixels, (("tiny", 24, 40, "4:2:0"),), ((9, 20),), 200
    ) == []


@pytest.mark.parametrize("restart", [1, 0])
def test_phase_entropy_tiny(restart):
    assert _run(
        chip_smoke.phase_entropy, (("tiny", 32, 48, "4:2:2"),), (restart,)
    ) == []


def test_phase_pack_corpus_tiny():
    assert _run(chip_smoke.phase_pack_corpus, (24, 40), (3, 32, 48)) == []


def test_phase_devices4_tiny():
    """The multi-card phase on 4 virtual CPU devices at tiny sizes."""
    assert _run(chip_smoke.phase_devices4, (32, 48), 8, (64, 96)) == []


def test_report_fails_on_exception(capsys):
    def boom(rep):
        raise RuntimeError("phase error")

    assert _run(boom) == ["boom"]


@pytest.mark.parametrize("restart", [2, 0])
def test_bits_to_rgb_programs_match_host(restart):
    """The programs the kernels are timed in decode what the host decodes
    (here on the plain route, the only compiled one on a CPU)."""
    import numpy as np

    from jaxjpeg.engine.decoder import HostDecoder
    from jaxjpeg.host.parser import parse

    build = chip_smoke._restart_program if restart else chip_smoke._scan_program
    data = chip_smoke.make_jpeg(40, 56, "4:2:0", restart=restart, seed=3)
    fn, args = build(parse(data))
    rgb = np.asarray(fn(*args)[0])[:40, :56]
    np.testing.assert_array_equal(rgb, HostDecoder(data).decode("rgb"))
