"""Does serving from several processes on one port (SO_REUSEPORT) buy
anything on this host? (port of scripts/exp_reuseport.py). N forked
server processes, N in (1, 2, 4), each an event loop serving the canned
POST /search body on the port's protocol (server/fastpath.HttpProtocol,
in place of the script's aiohttp), listen on one port through
loop.create_server(..., reuse_port=True); the kernel spreads the
connections over them. No engine, no card: the question is the host's
ceiling. The raw-socket pipelined client (4 threads, 8 requests in
flight each) drives each N.

The servers run on the server's cores and the client threads on the
client's (bench_server.core_split). Each child reports when it listens
(the script slept 1.5 s a process instead), and every child is
terminated and reaped before the next N.

    python -m rust_local_rag_tpu_torch.tools.reuseport [--seconds 8] [--clients 4] [--procs 1 2 4]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import multiprocessing as mp
import os

from rust_local_rag_tpu_torch.server.fastpath import HttpProtocol
from rust_local_rag_tpu_torch.tools import ceiling_common as cc
from rust_local_rag_tpu_torch.tools.http_ceiling import BODY, search  # noqa: F401 (the canned body)

SECONDS = 8.0
CLIENTS = 4
PROCS = (1, 2, 4)
START_TIMEOUT = 30.0


def server_proc(port: int, cores, ready) -> None:
    """One server process: the canned /search on `port`, shared by
    SO_REUSEPORT; runs until terminated."""
    if cores:
        os.sched_setaffinity(0, cores)
    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    app = cc.CannedApp(search)
    conns: set = set()
    loop.run_until_complete(loop.create_server(lambda: HttpProtocol(app, loop, conns), "127.0.0.1", port,
                                               reuse_port=True))
    ready.put(os.getpid())
    loop.run_forever()


def measure(nprocs: int, port: int, clients: int, seconds: float, split: dict) -> dict:
    ctx = mp.get_context("fork")
    ready = ctx.Queue()
    procs = [ctx.Process(target=server_proc, args=(port, split["server_cores"], ready), daemon=True)
             for _ in range(nprocs)]
    try:
        for p in procs:
            p.start()
        for _ in procs:
            ready.get(timeout=START_TIMEOUT)
        return cc.raw_load(port, clients, seconds, split["client_cores"])
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        ready.close()
        ready.join_thread()


def run(seconds: float = SECONDS, clients: int = CLIENTS, procs=PROCS, log=print) -> dict:
    split = cc.cores_line()
    log(json.dumps(split))
    port = cc.free_port()
    out = {**split, "port": port}
    for n in procs:
        r = measure(n, port, clients, seconds, split)
        out[f"reuseport_{n}proc_qps"] = r["qps"]
        out[f"reuseport_{n}proc_errors"] = r["errors"]
        log(f"{n} proc(s): {r['qps']:.0f} qps, errors {r['errors']}")
    out["errors"] = sum(out[f"reuseport_{n}proc_errors"] for n in procs)
    out["children_left"] = len(cc.children())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=SECONDS)
    ap.add_argument("--clients", type=int, default=CLIENTS)
    ap.add_argument("--procs", type=int, nargs="+", default=list(PROCS))
    args = ap.parse_args(argv)
    out = run(args.seconds, args.clients, tuple(args.procs), log=lambda m: print(m, flush=True))
    print(json.dumps({"reuseport": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
