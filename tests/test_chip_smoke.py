"""chip_smoke.py's argument handling and its refusal to run without a GPU
(the on-card phases themselves run only on the card)."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv,devices", [([], 1), (["--devices", "4"], 4)])
def test_arguments(argv, devices):
    assert chip_smoke.parse_args(argv).devices == devices


@pytest.mark.parametrize("argv", [
    ["--devices", "2"], ["--devices", "8"], ["--bogus"]])
def test_bad_arguments_exit_nonzero(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_args(argv)
    assert e.value.code != 0


def test_refuses_without_gpu():
    """On the CPU backend the script exits non-zero before doing any work
    and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert res.returncode != 0
    assert "needs an NVIDIA GPU" in res.stderr
    for line in res.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_device_report_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.device_report(1)


@pytest.mark.parametrize("shift,within", [(0, True), (3, True), (4, False)])
def test_diff_stats_limits(shift, within):
    """A uniform window shift of `shift` codes against limits median <= 3,
    p99 <= 7; a shape mismatch is an error, never a pass."""
    import numpy as np

    want = np.arange(1000, dtype=np.uint16).reshape(40, 25)
    res = chip_smoke.diff_stats("t", want + shift, want, 3.0, 7.0)
    assert (res["median"], res["mean_signed"], res["within"]) == (
        shift, shift, within)
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.diff_stats("t", want[:-1], want, 3.0, 7.0)


def test_watch_scene_mesh_sees_the_batched_program(tmp_path):
    """On the virtual CPU devices, --device-batch 4 over four same-shape
    scenes is one scene-mesh program over 4 devices, --device-batch 1 none;
    the watcher is removed afterwards."""
    import fixtures
    from sarpro_tpu.parallel import sharded

    real = sharded.synrgb_batch
    src = tmp_path / "in"
    src.mkdir()
    for i in range(4):
        fixtures.make_safe(src, name=f"s{i}.SAFE", seed=1)
    seen = {}
    for k in (4, 1):
        with chip_smoke.watch_scene_mesh() as calls:
            chip_smoke.cli([
                "--input-dir", str(src), "--output-dir", str(tmp_path / f"o{k}"),
                "--prefetch", "2", "--fast", "-f", "jpeg", "--polarization",
                "multiband", "--autoscale", "clahe", "--size", "32", "--pad",
                "--device-batch", str(k)])
        seen[k] = calls
    assert seen == {4: [{"scenes": 4, "mesh_devices": 4,
                         "result_devices": 4}], 1: []}
    assert sharded.synrgb_batch is real


def test_trace_reduction_needs_a_trace(tmp_path):
    with pytest.raises(RuntimeError, match="no profiler trace"):
        chip_smoke.trace_top(tmp_path)
