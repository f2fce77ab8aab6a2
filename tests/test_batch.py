"""Tests: pipelined batch driver."""
import functools

import numpy as np
import pytest
from PIL import Image

import fixtures
from sarpro_tpu import cli
from sarpro_tpu.params import ProcessingParams
from sarpro_tpu.parallel.batch import process_directory_pipelined
from sarpro_tpu.types import AutoscaleStrategy, OutputFormat, Polarization


def _setup(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="a.SAFE", seed=1)
    fixtures.make_safe(indir, name="b.SAFE", seed=2)
    fixtures.make_safe(indir, name="c.SAFE", seed=3)
    fixtures.make_safe(indir, name="slc.SAFE", product_type="SLC", seed=4)
    (indir / "junk").mkdir()
    return indir


def test_pipelined_batch_matches_serial_counters(tmp_path):
    indir = _setup(tmp_path)
    params = ProcessingParams(size=32, autoscale=AutoscaleStrategy.STANDARD)
    report = process_directory_pipelined(indir, tmp_path / "out", params,
                                         prefetch=2)
    assert report.processed == 3
    assert report.skipped == 2
    assert report.errors == 0
    for name in ("a", "b", "c"):
        assert (tmp_path / "out" / f"{name}.SAFE.tiff").exists()


def test_pipelined_batch_multiband_jpeg(tmp_path):
    indir = _setup(tmp_path)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=32,
    )
    report = process_directory_pipelined(indir, tmp_path / "out2", params,
                                         prefetch=3)
    assert report.processed == 3
    im = Image.open(tmp_path / "out2" / "a.SAFE.jpg")
    assert im.mode == "RGB"


def test_cli_prefetch_flag(tmp_path, capsys):
    indir = _setup(tmp_path)
    rc = cli.run([
        "--input-dir", str(indir), "--output-dir", str(tmp_path / "out3"),
        "--autoscale", "robust", "--size", "32", "--prefetch", "2",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Processed: 3" in out
    assert "Skipped: 2" in out


def test_pipelined_batch_fault_isolation(tmp_path, monkeypatch):
    """A loader crash on one scene must not take down the batch (the
    reference's per-scene error tolerance, extended to the threaded driver)."""
    import sarpro_tpu.parallel.batch as batch_mod

    indir = _setup(tmp_path)
    real_load = batch_mod._load_scene

    def flaky(path, params, shard_devices=0, direct_io=True):
        if path.name == "b.SAFE":
            raise RuntimeError("synthetic loader crash")
        return real_load(path, params, shard_devices, direct_io)

    monkeypatch.setattr(batch_mod, "_load_scene", flaky)
    params = ProcessingParams(size=32, autoscale=AutoscaleStrategy.STANDARD)
    report = process_directory_pipelined(indir, tmp_path / "outf", params,
                                         prefetch=2)
    # ThreadPoolExecutor surfaces the exception via future.result(); the
    # driver records it as an error and continues
    assert report.processed == 2
    assert report.errors == 1
    assert report.skipped == 2


def test_missing_pol_counts_as_skipped_both_paths(tmp_path):
    """A GRD product missing VH under --polarization
    multiband must land in `skipped`, not `errors`, on BOTH batch paths
    (reference: api/mod.rs:502-533 warnings-mode viability)."""
    from sarpro_tpu.api import process_directory_to_path

    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="full.SAFE", pols=("vv", "vh"), seed=1)
    fixtures.make_safe(indir, name="vvonly.SAFE", pols=("vv",), seed=2)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=32,
    )

    serial = process_directory_to_path(indir, tmp_path / "out_s", params)
    assert (serial.processed, serial.skipped, serial.errors) == (1, 1, 0)
    piped = process_directory_pipelined(indir, tmp_path / "out_p", params,
                                        prefetch=2)
    assert (piped.processed, piped.skipped, piped.errors) == (1, 1, 0)
    assert (tmp_path / "out_s" / "full.SAFE.jpg").exists()
    assert (tmp_path / "out_p" / "full.SAFE.jpg").exists()


def test_single_pol_missing_file_skipped(tmp_path):
    """HH requested but product is VV-only → skipped on the serial path."""
    from sarpro_tpu.api import process_directory_to_path

    indir = tmp_path / "in"
    indir.mkdir()
    fixtures.make_safe(indir, name="vvonly.SAFE", pols=("vv",), seed=3)
    params = ProcessingParams(polarization=Polarization.HH, size=32,
                              autoscale=AutoscaleStrategy.STANDARD)
    report = process_directory_to_path(indir, tmp_path / "out", params)
    assert (report.processed, report.skipped, report.errors) == (0, 1, 0)


def test_pipelined_fast_writer_thread_matches_serial_fast(tmp_path):
    """fast=True routes scenes through the fused pipeline with the deferred
    writer thread; outputs must be byte-identical to the serial fast path
    and counters must match."""
    from sarpro_tpu import api

    indir = _setup(tmp_path)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=32, pad=True,
    )
    report = process_directory_pipelined(indir, tmp_path / "pf", params,
                                         prefetch=2, fast=True)
    assert report.processed == 3
    assert report.skipped == 2
    assert report.errors == 0
    api.process_directory_to_path(indir, tmp_path / "sf", params, fast=True)
    for name in ("a", "b", "c"):
        piped = (tmp_path / "pf" / f"{name}.SAFE.jpg").read_bytes()
        serial = (tmp_path / "sf" / f"{name}.SAFE.jpg").read_bytes()
        assert piped == serial
        # sidecars written by the writer thread too
        assert (tmp_path / "pf" / f"{name}.SAFE.json").exists()


def test_pipelined_fast_write_error_is_counted(tmp_path, monkeypatch):
    """A failure inside the deferred write stage surfaces in the error
    counter, not as a silent drop."""
    import sarpro_tpu.core.fast_path as fp

    indir = _setup(tmp_path)

    def boom(*a, **k):
        raise RuntimeError("synthetic encode failure")

    monkeypatch.setattr(fp, "write_synrgb_jpeg", boom)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=32,
    )
    report = process_directory_pipelined(indir, tmp_path / "pe", params,
                                         prefetch=2, fast=True)
    assert report.processed == 0
    assert report.errors == 3
    assert report.skipped == 2


def test_device_batched_buckets_match_per_scene(tmp_path):
    """device_batch=2 over 4 same-shape scenes forms two full buckets whose
    vmapped outputs must be byte-identical to the per-scene fast path (on
    the CPU test platform both trace the same XLA kernels)."""
    from sarpro_tpu import api

    indir = tmp_path / "in4"
    indir.mkdir()
    for i, name in enumerate(("a", "b", "c", "d")):
        fixtures.make_safe(indir, name=f"{name}.SAFE", seed=10 + i)
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=32, pad=True,
    )
    report = process_directory_pipelined(indir, tmp_path / "db", params,
                                         prefetch=2, fast=True,
                                         device_batch=2)
    assert report.processed == 4 and report.errors == 0
    api.process_directory_to_path(indir, tmp_path / "ps", params, fast=True)
    for name in ("a", "b", "c", "d"):
        batched = (tmp_path / "db" / f"{name}.SAFE.jpg").read_bytes()
        single = (tmp_path / "ps" / f"{name}.SAFE.jpg").read_bytes()
        assert batched == single, name
        # per-scene sidecars written for batched scenes too
        assert (tmp_path / "db" / f"{name}.SAFE.json").exists()


@pytest.mark.parametrize("continue_on_error", [True, False])
def test_device_batched_dispatch_failure_is_an_error(tmp_path, monkeypatch,
                                                     continue_on_error):
    """A failed bucket dispatch counts every scene of the bucket as an
    error (or aborts the batch) — it is never re-run another way."""
    import sarpro_tpu.core.fast_path as fp

    indir = tmp_path / "in2"
    indir.mkdir()
    for i, name in enumerate(("a", "b")):
        fixtures.make_safe(indir, name=f"{name}.SAFE", seed=20 + i)
    per_scene = []

    def boom(*a, **k):
        raise RuntimeError("synthetic dispatch failure")

    monkeypatch.setattr(fp, "save_multiband_batch_fast", boom)
    monkeypatch.setattr(fp, "save_multiband_fast",
                        lambda *a, **k: per_scene.append(a))
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.TAMED, size=32,
    )
    run = functools.partial(
        process_directory_pipelined, indir, tmp_path / "out", params,
        continue_on_error=continue_on_error, prefetch=2, fast=True,
        device_batch=2)
    if continue_on_error:
        report = run()
        assert (report.processed, report.errors) == (0, 2)
    else:
        with pytest.raises(RuntimeError, match="synthetic dispatch"):
            run()
    assert per_scene == []
    assert not list((tmp_path / "out").glob("*.jpg"))


def test_device_batched_partial_bucket_and_mixed_shapes(tmp_path):
    """Scenes of two shapes with device_batch=3: neither bucket fills, so
    the tail flush runs per-scene; counters stay exact."""
    indir = tmp_path / "inmix"
    indir.mkdir()
    fixtures.make_safe(indir, name="s1.SAFE", seed=1)
    fixtures.make_safe(indir, name="s2.SAFE", seed=2)
    fixtures.make_safe(indir, name="big.SAFE", seed=3, shape=(128, 160))
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=32,
    )
    report = process_directory_pipelined(indir, tmp_path / "mix", params,
                                         prefetch=2, fast=True,
                                         device_batch=3)
    assert report.processed == 3 and report.errors == 0
    for name in ("s1", "s2", "big"):
        assert (tmp_path / "mix" / f"{name}.SAFE.jpg").exists()


def test_device_batched_mixed_shape_eviction_bounds_staging(tmp_path):
    """12 scenes of 12 distinct shapes with device_batch=4: no bucket ever
    fills, so the staged-scene cap (max(8, 2*K)=8) must evict the oldest
    partial buckets per-scene mid-run — every scene still processed once,
    no duplicates, outputs present (review finding: mixed-shape
    directories previously accumulated every scene until end-of-input)."""
    indir = tmp_path / "inhet"
    indir.mkdir()
    names = []
    for i in range(12):
        name = f"h{i}.SAFE"
        names.append(name)
        fixtures.make_safe(indir, name=name, seed=40 + i,
                           shape=(96 + 4 * i, 128))
    params = ProcessingParams(
        format=OutputFormat.JPEG, polarization=Polarization.MULTIBAND,
        autoscale=AutoscaleStrategy.CLAHE, size=32,
    )
    report = process_directory_pipelined(indir, tmp_path / "het", params,
                                         prefetch=2, fast=True,
                                         device_batch=4)
    assert report.processed == 12 and report.errors == 0
    for name in names:
        assert (tmp_path / "het" / f"{name}.jpg").exists()


def test_progress_callback_counts_every_scene(tmp_path):
    """GUI live-progress hook: done is monotonic, ends at total, and the
    current-scene name is surfaced (both batch drivers)."""
    from sarpro_tpu import api

    indir = _setup(tmp_path)
    params = ProcessingParams(size=32, autoscale=AutoscaleStrategy.STANDARD)
    for driver in ("pipelined", "serial"):
        events = []

        def cb(done, total, current):
            events.append((done, total, current))

        if driver == "pipelined":
            report = process_directory_pipelined(
                indir, tmp_path / f"o_{driver}", params, prefetch=2,
                progress=cb)
        else:
            report = api.process_directory_to_path(
                indir, tmp_path / f"o_{driver}", params, progress=cb)
        total = report.processed + report.skipped + report.errors
        assert events, driver
        dones = [e[0] for e in events]
        assert dones == sorted(dones), driver          # monotonic
        assert events[-1][0] == total == 5, driver     # 3 ok + 2 skipped
        assert all(e[1] == 5 for e in events), driver
        assert any(e[2] and e[2].endswith(".SAFE") for e in events), driver


def test_progress_callback_exceptions_do_not_break_batch(tmp_path):
    indir = _setup(tmp_path)
    params = ProcessingParams(size=32, autoscale=AutoscaleStrategy.STANDARD)

    def bad_cb(done, total, current):
        raise RuntimeError("observer crash")

    report = process_directory_pipelined(indir, tmp_path / "o_bad", params,
                                         prefetch=2, progress=bad_cb)
    assert report.processed == 3 and report.errors == 0
