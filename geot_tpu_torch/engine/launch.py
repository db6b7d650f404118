"""Multi-process training launcher (``geot_tpu/engine/launch.py``), the
``mp.spawn`` of the reference: one process per rank, each running
``engine.train`` with one shared run directory.

    # one node, 2 ranks: one card each (NCCL), or both on cuda:0 over gloo
    # when the node has one card
    python -m geot_tpu_torch.engine.launch --nprocs 2 -- \\
        --cfg cfgs/tooth_semi/transformer_finetune_fixmatch_ntm.yaml k=v ...

    # node 1 of a 2-node job (run once per node)
    python -m geot_tpu_torch.engine.launch --nprocs 1 --nnodes 2 \\
        --node-rank 1 --coordinator host0:12345 --run-dir /shared/run -- \\
        --cfg ...

    # the test mode: ranks on the CPU over gloo
    python -m geot_tpu_torch.engine.launch --nprocs 2 --devices-per-proc 1 \\
        -- --cfg cfgs/tooth_semi/smoke.yaml

Every rank gets the rendezvous in its environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``; ``parallel/dist.py`` reads them) and ``run_dir=`` /
``run_name=`` overrides naming the one run directory: the trainer gates
scalars, logs and checkpoints to rank 0 itself. A rank's output goes to
``<run_dir>/rank<i>.log``; rank 0's is also streamed here. A rank that
exits with an error terminates the others (fail-fast, like torchrun).

Each rank runs on ``cuda:<local rank>`` and uses NCCL when the node has a
card per rank; otherwise the ranks share ``cuda:0`` over gloo (NCCL refuses
two ranks on one device). ``--devices-per-proc 1`` runs them on the CPU over
gloo (``geot_tpu``'s flag forces N virtual CPU devices per process; a rank
of the port is one device, so N must be 1).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def find_free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _tee(stream, log, out) -> None:
    for line in iter(stream.readline, b""):
        log.write(line)
        log.flush()
        out.write(line.decode(errors="replace"))
        out.flush()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "geot_tpu_torch multi-process launcher (mp.spawn analogue)")
    parser.add_argument("--nprocs", type=int, required=True,
                        help="processes to spawn on THIS node")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node-rank", type=int, default=0)
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (required when nnodes>1; "
                             "defaults to localhost:<free port>)")
    parser.add_argument("--run-dir", default=None,
                        help="shared run directory (default: "
                             "./log/launch/<timestamp>)")
    parser.add_argument("--devices-per-proc", type=int, default=None,
                        help="run the ranks on the CPU over gloo (the test "
                             "mode; one device per rank, so 1)")
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="-- followed by engine.train arguments")
    args = parser.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if not train_args:
        parser.error("pass the training command after '--', e.g. "
                     "-- --cfg cfgs/tooth_semi/smoke.yaml")
    if args.nnodes > 1 and not args.coordinator:
        parser.error("--coordinator host:port is required when nnodes > 1")
    if args.nnodes > 1 and not args.run_dir:
        # every node must write to (and resume from) the same directory
        parser.error("--run-dir is required when nnodes > 1 (every node must "
                     "share one run directory for coordinated checkpoints)")
    if args.devices_per_proc is not None and args.devices_per_proc != 1:
        parser.error("--devices-per-proc: a rank of geot_tpu_torch is one "
                     "device, so N must be 1")

    num_processes = args.nnodes * args.nprocs
    host, port = ((args.coordinator.rsplit(":", 1)) if args.coordinator
                  else ("localhost", str(find_free_port())))
    run_dir = args.run_dir or os.path.join(
        "log", "launch", time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(run_dir, exist_ok=True)
    run_name = os.path.basename(os.path.normpath(run_dir))

    env = dict(os.environ)
    env.update({"MASTER_ADDR": host, "MASTER_PORT": port,
                "WORLD_SIZE": str(num_processes),
                "LOCAL_WORLD_SIZE": str(args.nprocs),
                "PYTHONPATH": os.pathsep.join(
                    p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)})
    extra = [f"run_dir={run_dir}", f"run_name={run_name}"]
    if args.devices_per_proc:
        # the node's cores shared out, not every rank on all of them
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // args.nprocs)))
        extra.append("device=cpu")

    procs, logs, tees = [], [], []
    for local in range(args.nprocs):
        rank = args.node_rank * args.nprocs + local
        cmd = [sys.executable, "-m", "geot_tpu_torch.engine.train",
               *train_args, *extra]
        log = open(os.path.join(run_dir, f"rank{rank}.log"), "wb")
        logs.append(log)
        p = subprocess.Popen(
            cmd, env=dict(env, RANK=str(rank), LOCAL_RANK=str(local)),
            stdout=subprocess.PIPE if rank == 0 else log,
            stderr=subprocess.STDOUT)
        procs.append(p)
        if rank == 0:       # streamed through as well
            t = threading.Thread(target=_tee, args=(p.stdout, log,
                                                    sys.stdout), daemon=True)
            t.start()
            tees.append(t)
    print(f"launched {args.nprocs} process(es) "
          f"(global ranks {args.node_rank * args.nprocs}.."
          f"{args.node_rank * args.nprocs + args.nprocs - 1} of "
          f"{num_processes}); logs in {run_dir}/rank*.log", flush=True)

    # fail-fast: one dead rank hangs the others on their next collective,
    # so terminate the group as soon as any rank exits nonzero
    rc = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0:
                    rc = code
                    print(f"rank exited with {code}; terminating the rest",
                          file=sys.stderr, flush=True)
                    for q in live:
                        q.terminate()
                    for q in live:
                        try:
                            q.wait(timeout=30)
                        except subprocess.TimeoutExpired:
                            # a rank wedged in a collective ignores SIGTERM
                            q.kill()
                            q.wait()
                    live = []
                    break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in tees:
            t.join(timeout=30)
        for log in logs:
            log.close()
    if rc == 0:
        print(f"all ranks finished; run dir {run_dir}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
