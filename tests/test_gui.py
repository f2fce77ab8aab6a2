"""Tests: GUI server API (state, presets, CLI generator, process worker)."""
import json
import threading
import time
import urllib.request

import pytest

import fixtures
from sarpro_tpu.gui.server import make_server
from sarpro_tpu.gui.state import GuiState, generate_cli_command


@pytest.fixture
def server():
    srv = make_server("127.0.0.1", 0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return json.loads(r.read())


def _post(base, path, obj):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_index_and_state(server):
    with urllib.request.urlopen(server + "/", timeout=10) as r:
        html = r.read().decode()
    assert "sarproUI" in html and "Autoscale" in html
    state = _get(server, "/api/state")
    assert state["params"]["autoscale"] == "Clahe"
    assert state["running"] is False


def test_state_update_and_cli_generator(server):
    _post(server, "/api/state", {
        "mode": "batch", "input_dir": "/d/in", "output_dir": "/d/out",
        "prefetch": 3,
        "params": {"format": "JPEG", "polarization": "multiband",
                   "autoscale": "tamed", "size": 2048, "pad": True,
                   "target_crs": "auto"},
    })
    cmd = _get(server, "/api/cli")["command"]
    assert "--input-dir /d/in" in cmd
    assert "-f jpeg" in cmd
    assert "--polarization multiband" in cmd
    assert "--autoscale tamed" in cmd
    assert "--size 2048" in cmd and "--pad" in cmd
    assert "--target-crs auto" in cmd and "--prefetch 3" in cmd


def test_preset_roundtrip(server, tmp_path):
    p = tmp_path / "x.sarpro"
    _post(server, "/api/state", {"params": {"autoscale": "robust", "size": 512}})
    _post(server, "/api/preset/save", {"path": str(p)})
    text = p.read_text()
    assert text.startswith("//")  # commented JSON header (models.rs:208-341)
    _post(server, "/api/state", {"params": {"autoscale": "clahe", "size": None}})
    loaded = _post(server, "/api/preset/load", {"path": str(p)})
    assert loaded["params"]["autoscale"] == "Robust"
    assert loaded["params"]["size"] == 512


def test_process_single_file(server, tmp_path):
    base = fixtures.make_safe(tmp_path)
    out = tmp_path / "gui_out.tiff"
    _post(server, "/api/state", {
        "mode": "single", "input_path": str(base), "output_path": str(out),
        "params": {"autoscale": "standard", "size": 32},
    })
    assert _post(server, "/api/process", {})["started"]
    for _ in range(600):
        s = _get(server, "/api/state")
        if not s["running"] and s["last_result"]:
            break
        time.sleep(0.1)
    assert s["last_result"]["ok"], s["last_result"]
    assert out.exists()
    # logs flowed through the ring buffer
    logs = _get(server, "/api/logs")
    assert isinstance(logs, list)


def test_cli_generator_defaults():
    state = GuiState()
    cmd = generate_cli_command(state)
    assert cmd.startswith("sarpro -i")
    assert "--autoscale clahe" in cmd
    assert "--bit-depth" not in cmd  # u8 default omitted


def test_listdir_endpoint(server, tmp_path):
    """Server-side browse dialog (the rfd file-dialog equivalent)."""
    base = fixtures.make_safe(tmp_path, name="S1A_PICK.SAFE", pols=("vv",))
    (tmp_path / "plain_dir").mkdir()
    (tmp_path / "out.tiff").write_bytes(b"x")
    (tmp_path / ".hidden").mkdir()
    import urllib.parse

    d = _get(server, "/api/listdir?path=" + urllib.parse.quote(str(tmp_path)))
    assert d["path"] == str(tmp_path)
    assert d["parent"] == str(tmp_path.parent)
    names = {e["name"]: e for e in d["entries"]}
    assert names["S1A_PICK.SAFE"]["dir"] and names["S1A_PICK.SAFE"]["safe"]
    assert names["plain_dir"]["dir"] and not names["plain_dir"]["safe"]
    assert not names["out.tiff"]["dir"]
    assert ".hidden" not in names
    # dirs sort before files
    entry_names = [e["name"] for e in d["entries"]]
    assert entry_names.index("plain_dir") < entry_names.index("out.tiff")
    # navigating into the SAFE dir works
    d2 = _get(server, "/api/listdir?path="
              + urllib.parse.quote(str(base)))
    assert {"annotation", "measurement"} <= {e["name"] for e in d2["entries"]}
    # non-dir -> 400
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(server, "/api/listdir?path="
             + urllib.parse.quote(str(tmp_path / "out.tiff")))
    assert ei.value.code == 400


def test_html_js_server_consistency():
    """Headless-CI stand-in for a browser smoke test: every element id the
    page script references must exist in the markup, every onclick handler
    must be defined, and every fetched /api route must be handled by
    server.py (a regression in static/index.html now fails CI)."""
    import re
    from pathlib import Path

    import sarpro_tpu.gui.server as server_mod

    html = (Path(server_mod.__file__).parent / "static" / "index.html").read_text()
    script = html.split("<script>")[1].split("</script>")[0]
    markup = html.split("<script>")[0]

    dom_ids = set(re.findall(r'id="([^"]+)"', markup))
    # ids referenced via $('...') and getElementById('...')
    referenced = set(re.findall(r"\$\('([^']+)'\)", script))
    referenced |= set(re.findall(r"getElementById\('([^']+)'\)", script))
    missing = referenced - dom_ids
    assert not missing, f"script references ids missing from markup: {missing}"

    # onclick handlers must be defined functions in the script
    handlers = {m.split("(")[0] for m in re.findall(r'onclick="([^"]+)"', markup)}
    defined = set(re.findall(r"(?:async\s+)?function\s+(\w+)", script))
    defined |= {"document"}  # inline document.getElementById(...) clear button
    undefined = {h for h in handlers if h.split(".")[0] not in defined}
    assert not undefined, f"onclick handlers not defined: {undefined}"

    # every fetched endpoint handled server-side
    server_src = Path(server_mod.__file__).read_text()
    for route in set(re.findall(r"fetch\('(/api/[a-z-]+)", script)):
        assert f'"{route}"' in server_src or f'"{route}' in server_src, \
            f"page fetches {route} but server.py has no handler"


def test_forbidden_host_header_rejected(server):
    """DNS-rebinding guard: any non-local Host header gets 403 on every
    endpoint (the filesystem-listing /api/listdir especially)."""
    for path in ("/api/listdir", "/api/state"):
        req = urllib.request.Request(server + path,
                                     headers={"Host": "evil.example.com"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 403
    # legitimate localhost requests still pass
    assert "entries" in _get(server, "/api/listdir")


def test_fast_mode_toggle_and_cli_generation(server):
    """The GUI's fast-mode toggle reaches the worker snapshot and the CLI
    generator (parity extension: the CLI's --fast)."""
    s = _post(server, "/api/state", {"fast": True, "mode": "batch",
                                     "input_dir": "/tmp/in",
                                     "output_dir": "/tmp/out"})
    assert s["fast"] is True
    cmd = _get(server, "/api/cli")["command"]
    assert "--fast" in cmd and "--prefetch" in cmd


def test_log_cursor_protocol(server):
    """`/api/logs?since=N` must return only events past the cursor so the
    page never re-renders history (the legacy no-arg form stays a list)."""
    import logging

    logging.getLogger("sarpro").setLevel(logging.INFO)
    logging.getLogger("sarpro").info("cursor-probe-1")
    d = _get(server, "/api/logs?since=0")
    assert set(d) == {"next", "events"}
    n1 = d["next"]
    assert n1 == len(d["events"]) and n1 >= 1
    # no new events -> empty delta, stable cursor
    d2 = _get(server, f"/api/logs?since={n1}")
    assert d2["events"] == [] and d2["next"] == n1
    logging.getLogger("sarpro").info("cursor-probe-2")
    d3 = _get(server, f"/api/logs?since={n1}")
    assert [e["message"] for e in d3["events"]] == ["cursor-probe-2"]
    assert d3["next"] == n1 + 1


def test_listdir_recents(server, tmp_path):
    import urllib.parse

    a = tmp_path / "a"
    b = tmp_path / "b"
    a.mkdir()
    b.mkdir()
    _get(server, "/api/listdir?path=" + urllib.parse.quote(str(a)))
    d = _get(server, "/api/listdir?path=" + urllib.parse.quote(str(b)))
    assert d["recents"][0] == str(b)
    assert str(a) in d["recents"]


def test_preview_endpoint(server, tmp_path):
    """After a single-file run the GUI serves a rendered output preview
    (TIFF re-rendered to PNG; JPEG as-is); 404 before any run."""
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server + "/api/preview", timeout=10)
    assert ei.value.code == 404

    base = fixtures.make_safe(tmp_path)
    out = tmp_path / "prev.tiff"
    _post(server, "/api/state", {
        "mode": "single", "input_path": str(base), "output_path": str(out),
        "params": {"autoscale": "standard", "size": 32, "bit_depth": "U16"},
    })
    assert _post(server, "/api/process", {})["started"]
    for _ in range(600):
        s = _get(server, "/api/state")
        if not s["running"] and s["last_result"]:
            break
        time.sleep(0.1)
    assert s["last_result"]["ok"], s["last_result"]
    with urllib.request.urlopen(server + "/api/preview", timeout=10) as r:
        assert r.headers["Content-Type"] == "image/png"
        png = r.read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    # decodes to the output's shape
    import io as _io

    from PIL import Image

    im = Image.open(_io.BytesIO(png))
    assert im.size == (32, 24)  # 128x96 fixture scene at size 32


def test_log_cursor_stale_after_restart_resends(server):
    """A cursor larger than the server's total (page older than a server
    restart) must resend the full history, not silently skip events."""
    import logging

    logging.getLogger("sarpro").setLevel(logging.INFO)
    logging.getLogger("sarpro").info("restart-probe")
    d = _get(server, "/api/logs?since=999999")
    assert d["next"] >= 1
    assert any(e["message"] == "restart-probe" for e in d["events"])


def test_preview_corrupt_output_returns_415(server, tmp_path):
    """A corrupt output file must produce a JSON 415, not kill the
    handler thread."""
    import urllib.error

    base = fixtures.make_safe(tmp_path)
    out = tmp_path / "c.tiff"
    _post(server, "/api/state", {
        "mode": "single", "input_path": str(base), "output_path": str(out),
        "params": {"autoscale": "standard", "size": 32},
    })
    assert _post(server, "/api/process", {})["started"]
    for _ in range(600):
        s = _get(server, "/api/state")
        if not s["running"] and s["last_result"]:
            break
        time.sleep(0.1)
    assert s["last_result"]["ok"]
    out.write_bytes(b"not a tiff at all")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server + "/api/preview", timeout=10)
    assert ei.value.code == 415


def test_preview_decimation_content_exact(tmp_path):
    """render_preview's block-decimated read must equal a straight
    [::step, ::step] subsample of the raster (this pinned a bug where the
    column decimation was dropped), and tiled layouts must render without
    per-row full-read fallbacks."""
    import io as _io

    import numpy as np
    from PIL import Image

    from sarpro_tpu.gui.server import render_preview
    from sarpro_tpu.io.tiffio import TiffWriter

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 65535, (5000, 3000)).astype(np.uint16)
    p = tmp_path / "big.tiff"
    TiffWriter(p).write([arr])
    png, ctype = render_preview(p)
    assert ctype == "image/png"
    im = Image.open(_io.BytesIO(png))
    assert im.size == (600, 1000)  # step = ceil(5000/1024) = 5
    sub = arr[::5, ::5].astype(np.float32)
    lo, hi = float(sub.min()), float(sub.max())
    expect = np.clip((sub - lo) / (hi - lo) * 255.0 + 0.5,
                     0, 255).astype(np.uint8)
    assert np.array_equal(np.asarray(im.convert("L")), expect)


def test_crs_validation_endpoint(server):
    """Live target-CRS field validation: name + method + backend tier."""
    d = _get(server, "/api/crs?value=none")
    assert d["ok"] is True and d["method"] == "none"
    d = _get(server, "/api/crs?value=auto")
    assert d["ok"] is True and "centroid" in d["name"]
    d = _get(server, "/api/crs?value=EPSG%3A32633")
    assert d["ok"] is True and "Transverse Mercator" in d["method"]
    assert d["backend"] == "native tables"
    d = _get(server, "/api/crs?value=EPSG%3A999999")
    assert d["ok"] is False and "not known" in d["reason"]
    d = _get(server, "/api/crs?value=garbage")
    assert d["ok"] is False


def test_crs_validation_endpoint_pipe_tier(server):
    import shutil

    if shutil.which("cs2cs") is None or shutil.which("projinfo") is None:
        pytest.skip("PROJ tools missing")
    d = _get(server, "/api/crs?value=EPSG%3A3375")
    assert d["ok"] is True and "cs2cs pipe" in d["backend"]
    assert "RSO" in d["name"]


def test_shard_devices_state_and_cli_generator(server):
    st = _get(server, "/api/state")
    assert st.get("shard_devices", 0) == 0
    _post(server, "/api/state", {"shard_devices": 8, "fast": True,
                                 "input_path": "/x.SAFE",
                                 "output_path": "/x.tiff"})
    cmd = _get(server, "/api/cli")["command"]
    assert "--shard-devices 8" in cmd


def test_crs_validation_proj_string_no_registration(server):
    from sarpro_tpu.io import geodesy

    before = dict(geodesy._PROJ_STRING_CODES)
    d = _get(server, "/api/crs?value=" + urllib.parse.quote(
        "+proj=tmerc +lat_0=0 +lon_0=9 +k=0.9996 +datum=WGS84"))
    assert d["ok"] is True and "Transverse Mercator" in d["method"]
    assert "proj string" in d["backend"]
    d = _get(server, "/api/crs?value=" + urllib.parse.quote(
        "+proj=moll +lon_0=10 +datum=WGS84"))
    assert d["ok"] is True
    # the interactive hint must not pollute the registration caches
    assert geodesy._PROJ_STRING_CODES == before
