"""The port's host ceilings (tools/stack_ceiling.py, http_ceiling.py,
proto_ceiling.py, reuseport.py): no JAX function lies behind them (the
scripts measure aiohttp, the port serves with its own protocol), so they
are held to the scripts' canned bodies and requests, byte for byte, read
from the scripts' source with ast (exp_http_ceiling and
exp_proto_ceiling run when imported), and each main runs for 0.5 s with 2
clients: 0 errors, every child reaped, its port free again."""

import ast
import json
import os
import subprocess
import sys

import pytest

from rust_local_rag_tpu_torch.server.http_api import Response
from rust_local_rag_tpu_torch.tools import ceiling_common as cc
from rust_local_rag_tpu_torch.tools import http_ceiling, proto_ceiling, reuseport, stack_ceiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script_value(script: str, name: str, env: dict):
    """The value assigned to `name` at the top of scripts/<script>.py,
    evaluated in `env` without running the script."""
    with open(os.path.join(ROOT, "scripts", f"{script}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and any(getattr(t, "id", None) == name
                                                                          for t in n.targets))
    return eval(compile(ast.Expression(node.value), script, "eval"), dict(env))


@pytest.mark.parametrize("script", ["exp_http_ceiling", "exp_reuseport"])
def test_canned_body_and_request_are_the_scripts(script):
    assert script_value(script, "BODY", {"json": json}) == http_ceiling.BODY
    assert script_value(script, "REQ", {}) == cc.REQ
    assert reuseport.BODY is http_ceiling.BODY


def test_proto_payload_is_the_scripts():
    results = script_value("exp_proto_ceiling", "results", {})
    assert results == proto_ceiling.results
    assert json.dumps({"results": results}) == json.dumps(proto_ceiling.payload)


def test_canned_app_answers_the_scripts_bytes():
    server, thread = cc.serve(cc.CannedApp(http_ceiling.search))
    try:
        import http.client

        c = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
        c.request("POST", "/search", body=b'{"query": "probe"}')
        r = c.getresponse()
        assert r.status == 200 and r.read() == http_ceiling.BODY
        c.request("GET", "/search")
        r = c.getresponse()
        assert r.status == 405 and r.getheader("Allow") == "POST"
        r.read()
        c.request("POST", "/nowhere", body=b"{}")
        r = c.getresponse()
        assert r.status == 404
        r.read()
        c.close()
    finally:
        cc.stop(server, thread)
    assert cc.port_free(server.port)


def test_raw_load_counts_what_is_not_200():
    server, thread = cc.serve(cc.CannedApp(lambda req: Response(500, b"no", "text/plain")))
    try:
        r = cc.raw_load(server.port, 2, 0.3)
    finally:
        cc.stop(server, thread)
    assert r["responses"] > 0 and r["errors"] == r["responses"]


@pytest.fixture
def clean():
    """-> check(out): 0 errors, no child process of this one that was not
    there before the test (a test process may hold others), the port free."""
    before = set(cc.children())

    def check(out: dict) -> None:
        assert out["errors"] == 0 and out["children_left"] <= len(before)
        assert set(cc.children()) <= before
        assert cc.port_free(out["port"])

    return check


@pytest.mark.parametrize("argv", [["null", "2", "0.5"], ["bm25", "2", "0.5", "3000"]])
def test_stack_ceiling_main(argv, clean):
    out = stack_ceiling.main(argv)
    clean(out)
    assert out["mode"] == argv[0] and out["responses"] > 0 and out["qps"] > 0
    assert out["chunks"] == (3000 if argv[0] == "bm25" else 4096)


def test_stack_ceiling_fake_engine_serves_the_hot_lane():
    """The fake engine's rows, through the port's serializer, are the
    script's canned top-100 on registered slots."""
    from rust_local_rag_tpu_torch.server.serializer import ResponseSerializer

    eng = stack_ceiling.FakeEngine(200, "bm25", [f"chunk{i} term{i % 7}" for i in range(200)])
    col = eng.fetch_columnar(eng.dispatch_search(["term3 probe", "term4"], 100))
    ser = ResponseSerializer(lambda: eng.store)
    bodies = ser.serialize_batch(col.slots, col.vals, col.emb, col.lex, floor=col.floor)
    res = [json.loads(b)["results"] for b in bodies]
    assert [len(r) for r in res] == [100, 100]
    assert [r["chunk_id"] for r in res[0]] == [f"c{i}" for i in range(100)]
    assert res[0][0]["score"] == pytest.approx(0.9) and res[0][-1]["score"] == pytest.approx(0.5)
    assert (eng._out_s >= 0).sum() > 0  # the BM25 index scored the last query


def test_http_ceiling_main(clean):
    out = http_ceiling.main(["--seconds", "0.5", "--clients", "2"])
    clean(out)
    assert out["client"]["responses"] > 0 and out["raw1"]["responses"] > 0 and out["raw4"]["responses"] > 0
    assert set(out["server_cores"]).isdisjoint(out["client_cores"]) or out["usable_cores"] == 1


def test_proto_ceiling_main(clean):
    out = proto_ceiling.main(["--seconds", "0.5", "--clients", "2"])
    clean(out)
    assert out["responses"] > 0 and out["payload_bytes"] == len(json.dumps(proto_ceiling.payload))


def test_reuseport_main_as_a_process(clean):
    """python -m ...reuseport, N in (1, 2): its forked servers are reaped
    (none left in its session) and the shared port is free afterwards."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "rust_local_rag_tpu_torch.tools.reuseport", "--seconds", "0.5",
                             "--clients", "2", "--procs", "1", "2"], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-2000:]
    out = json.loads(stdout.strip().splitlines()[-1])["reuseport"]
    assert out["children_left"] == 0
    clean(out)
    assert out["reuseport_1proc_qps"] > 0 and out["reuseport_2proc_qps"] > 0
    assert cc.in_session(proc.pid) == []
