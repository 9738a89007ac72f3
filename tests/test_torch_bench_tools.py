"""The bench tools of the PyTorch port (`tools/torch_bench_arches.py`,
`torch_bench_host_loader.py`, `torch_vitl_ceiling.py`,
`torch_serve_coldstart.py`) on the CPU, as
tests/test_bench.py drives tools/bench_arches.py.

- `torch_bench_arches --rows test-tiny,test-tiny:text` with
  TTL_BENCH_PLATFORM=cpu: one JSON line, the same in `--out`, a row each
  with its arch-relative window, a wall rate and its launches (none on the
  CPU); it refuses to write BENCH_ARCHES.json.
- `torch_bench_host_loader` over 12 JPEGs: native and PIL rates.
- `torch_vitl_ceiling --floor-only`: the JAX tool's FLOP counts for
  ViT-L/14 and ViT-B/16, against the H100's bf16 peak; a measured row at
  test-tiny on the CPU (no device time there).
- `torch_serve_coldstart` against a stand-in server process (the port's
  server needs a card): the READY and first-answer seconds, and exit 1 for
  a server that dies before its READY line.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

import test_torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_tool(name: str):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_bench_arches_rows_on_the_cpu(tmp_path):
    out_path = tmp_path / "arches.json"
    env = {**test_torch_threads.subprocess_env(), "TTL_BENCH_PLATFORM": "cpu"}
    r = subprocess.run(
        [sys.executable, os.path.join("tools", "torch_bench_arches.py"),
         "--rows", "test-tiny,test-tiny:text", "--classes", "5", "--s", "2",
         "--windows", "1", "--iters", "2", "--out", str(out_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    assert out == json.loads(out_path.read_text())
    assert out["missing_rows"] == [] and out["device"]["name"] == "cpu"
    image, text = out["rows"]
    assert (image["row"], image["lora_encoder"]) == ("test-tiny", "image")
    assert (text["row"], text["lora_encoder"]) == ("test-tiny:text", "text")
    for row in (image, text):
        assert row["arch"] == "test-tiny" and row["wall_sps"] > 0
        assert row["layer_range"] == [1, 3]  # the last 3 of 4 layers
        assert row["launches"] == {"K1": 0, "K2": 0, "K5": 0, "K6": 0,
                                   "K6 linear": 0}
        assert "busy_sps" not in row and "error" not in row


def test_bench_arches_refuses_the_jax_record():
    tool = load_tool("torch_bench_arches")
    with pytest.raises(SystemExit):
        tool.main(["--out", os.path.join(REPO, "BENCH_ARCHES.json")])


def test_host_loader_native_and_pil(capsys):
    out = load_tool("torch_bench_host_loader").main(
        ["--n", "12", "--workers", "2", "--batch", "4"])
    assert out["n"] == 12 and out["native_available"] in (True, False)
    assert out["pil_sps"] > 0
    if out["native_available"]:
        assert out["native_sps"] > 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_ceiling_floor_matches_the_jax_tool():
    sys.path.insert(0, REPO)
    jtool = load_tool("vitl_ceiling")
    tool = load_tool("torch_vitl_ceiling")
    for arch in ("ViT-L/14", "ViT-B/16"):
        got, want = tool.flop_floor(arch), jtool.flop_floor(arch)
        for key in ("layers", "hidden", "heads", "tokens", "views", "window",
                    "prefix_tflop", "window_fwd_tflop", "backward_tflop",
                    "total_tflop_per_sample"):
            assert got[key] == want[key], key
        assert got["peak_tflops"] == 989.0
        assert got["ms_per_sample_at_peak"] == pytest.approx(
            got["total_tflop_per_sample"] / 989.0 * 1e3, rel=1e-3)
    out = tool.main(["--floor-only"])
    assert out["floor"]["window"] == [21, 23] and out["rows"] == []


def test_ceiling_row_at_test_tiny_on_the_cpu(monkeypatch):
    monkeypatch.setenv("TTL_BENCH_PLATFORM", "cpu")
    out = load_tool("torch_vitl_ceiling").main(
        ["--arch", "test-tiny", "--s_list", "2", "--classes", "5",
         "--windows", "1", "--iters", "2"])
    (row,) = out["rows"]
    assert row["s"] == 2 and row["wall_sps"] > 0
    assert "busy_ms_per_step" not in row and out["device"]["name"] == "cpu"


FAKE_SERVER = textwrap.dedent("""
    import json, sys
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            body = json.dumps({"label": "goldfish"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = HTTPServer(("127.0.0.1", int(sys.argv[1])), Handler)
    print("stand-in serving on", sys.argv[1], flush=True)
    httpd.serve_forever()
""")


def test_serve_coldstart_times_ready_and_first_answer(tmp_path, monkeypatch,
                                                      capsys):
    script = tmp_path / "server.py"
    script.write_text(FAKE_SERVER)
    tool = load_tool("torch_serve_coldstart")
    monkeypatch.setattr(tool, "server_cmd", lambda args, port: [
        sys.executable, str(script), str(port)])
    assert tool.main(["--runs", "2", "--timeout", "60"]) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert len(out["runs"]) == 2
    assert 0 < out["best_ready_s"] < 60 and out["best_first_request_s"] > 0

    monkeypatch.setattr(tool, "server_cmd", lambda args, port: [
        sys.executable, "-c", "raise SystemExit(3)"])
    assert tool.main(["--runs", "1", "--timeout", "60"]) == 1
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert "no READY line" in out["runs"][0]["error"]
    assert "best_ready_s" not in out
