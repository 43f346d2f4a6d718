"""Every port example end to end, in-process, on the CPU (the counterpart
of tests/test_examples_smoke.py): each runs as ``python -m
zignal_tpu_torch.examples.<name> INPUT --device cpu --out DIR`` on a
96x128 PNG, writing only into DIR."""

import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_EXAMPLES = sorted(p.stem for p in (REPO / "examples").glob("*.py")
                      if not p.name.startswith("_"))
PORT_EXAMPLES = sorted(
    p.stem for p in (REPO / "zignal_tpu_torch" / "examples").glob("*.py")
    if not p.name.startswith("_"))


@pytest.fixture(scope="module")
def small_png(tmp_path_factory):
    from zignal_tpu_torch.codecs import save_array

    arr = np.random.default_rng(0).integers(0, 256, (96, 128, 3),
                                            dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("examples") / "input.png")
    save_array(path, arr)
    return path


def test_every_example_has_a_port_of_the_same_name():
    assert PORT_EXAMPLES == JAX_EXAMPLES
    assert (REPO / "zignal_tpu_torch" / "examples" / "_common.py").exists()


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_example_runs_on_the_cpu(name, small_png, tmp_path, monkeypatch,
                                 capsys):
    import torch.distributed as dist

    out = tmp_path / "out"
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name, small_png, "--device", "cpu",
                                      "--out", str(out)])
    runpy.run_module(f"zignal_tpu_torch.examples.{name}",
                     run_name="__main__")
    assert not dist.is_initialized()  # a group it started is torn down
    printed = capsys.readouterr().out
    wrote = sorted(os.listdir(out)) if out.exists() else []
    assert wrote or printed
    assert sorted(os.listdir(tmp_path)) == (["out"] if out.exists() else [])


def test_the_default_device_is_the_card(small_png, tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(sys, "argv", ["edge_detection", small_png,
                                      "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module("zignal_tpu_torch.examples.edge_detection",
                         run_name="__main__")
    assert exc.value.code == 2
    assert os.listdir(tmp_path) == []
