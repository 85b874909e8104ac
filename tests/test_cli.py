"""CLI surface: the reference's app-layer switches (jpeg_gpu.c:473-700)."""

import numpy as np
import pytest

from jaxjpeg.cli import main
from jaxjpeg.testing import corpus


@pytest.fixture()
def jpg(tmp_path):
    img = corpus.synthetic_rgb(32, 48, seed=1)
    p = tmp_path / "t.jpg"
    p.write_bytes(corpus.pil_jpeg(img, quality=85, subsampling="4:2:0"))
    return str(p)


def test_cli_no_gpu_alias(jpg, capsys):
    assert main(["--no-gpu", jpg]) == 0
    assert "(host," in capsys.readouterr().out


def test_cli_no_cpu_alias(jpg, capsys):
    assert main(["--no-cpu", jpg]) == 0
    assert "(device," in capsys.readouterr().out


def test_cli_no_gpu_no_cpu_conflict(jpg):
    assert main(["--no-gpu", "--no-cpu", jpg]) == 2


def test_cli_header(jpg, capsys):
    assert main(["-H", jpg]) == 0
    out = capsys.readouterr().out
    assert "48" in out and "32" in out
