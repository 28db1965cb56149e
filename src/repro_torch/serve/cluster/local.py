"""Local cluster launcher of the port: real subprocess shard servers on
loopback sockets (DESIGN.md §8.2) — what the cluster tests,
``chip_smoke.py``'s ``cluster`` phase and ``repro_torch.launch.serve
--role router`` stand on.  Every node runs
``python -m repro_torch.serve.cluster.shard_server`` on ``device``
(``cuda`` unless the caller asks for the CPU); the nodes of one cluster
share that device.

``LocalCluster.launch(index, root)`` bootstraps a durable store from a
built index, spawns one primary + N scorers (+ optional replicas) as
separate Python processes, scrapes each child's ``READY <port>`` line,
and hands out ``ClusterRouter``s.  Processes are REAL processes on
purpose: kill -9 in the fault suite must kill an OS process mid-stream,
not a thread pretending to be one.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

__all__ = ["LocalCluster", "NodeHandle"]

_READY_TIMEOUT_S = 180.0


def _src_path() -> str:
    """The directory holding the ``repro_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


class NodeHandle:
    """One spawned shard-server process: its role, bound port, and the
    Popen handle (``kill()`` delivers SIGKILL — the fault suite's
    mid-stream crash)."""

    def __init__(self, name: str, role: str, proc: subprocess.Popen,
                 port: int | None, log_path: str):
        self.name = name
        self.role = role
        self.proc = proc
        self.port = port
        self.log_path = log_path

    @property
    def addr(self) -> str:
        """Loopback ``host:port`` endpoint of this node."""
        return f"127.0.0.1:{self.port}"

    def kill(self) -> None:
        """SIGKILL the process (no shutdown handshake — the crash the
        fault-injection tests need) and reap it."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait()

    def alive(self) -> bool:
        """True while the process has not exited."""
        return self.proc.poll() is None


class LocalCluster:
    """Owner of one locally spawned cluster (primary + scorers +
    replicas).  Use as a context manager — ``close()`` SIGKILLs whatever
    is still running.  ``launch`` is the one-call path from a built
    mutable index; ``__init__`` attaches to an existing store root.
    ``device`` goes to every node as ``--device``."""

    def __init__(self, root: str, *, num_scorers: int = 2,
                 num_replicas: int = 0, backend: str | None = None,
                 device: str = "cuda"):
        self.root = root
        self.backend = backend
        self.device = str(device)
        self.num_scorers = num_scorers
        self.primary: NodeHandle | None = None
        self.scorers: list[NodeHandle] = []
        self.replicas: list[NodeHandle] = []
        os.makedirs(os.path.join(root, "logs"), exist_ok=True)
        try:
            self.primary = self._spawn("primary", "primary",
                                       store=os.path.join(root, "store"))
            # the followers bootstrap from the primary at once: start them
            # all, then wait for each one's READY
            for s in range(num_scorers):
                self.scorers.append(self._start(
                    f"scorer-{s}", "scorer", shard=s,
                    workdir=os.path.join(root, f"scorer-{s}")))
            for r in range(num_replicas):
                self.replicas.append(self._start(
                    f"replica-{r}", "replica",
                    store=os.path.join(root, f"replica-{r}", "store")))
            for h in [*self.scorers, *self.replicas]:
                self._wait_ready(h)
        except BaseException:
            self.close()             # no node outlives a failed launch
            raise

    @classmethod
    def launch(cls, index, root: str, *, num_scorers: int = 2,
               num_replicas: int = 0, backend: str | None = None,
               device: str = "cuda") -> "LocalCluster":
        """Bootstrap ``root/store`` from a freshly built mutable index
        (initial snapshot + empty WAL, handle closed so the primary
        subprocess owns the log), then spawn the cluster."""
        index.save(os.path.join(root, "store"))
        return cls(root, num_scorers=num_scorers,
                   num_replicas=num_replicas, backend=backend,
                   device=device)

    def _spawn(self, name: str, role: str, **kw) -> NodeHandle:
        """Start one node and wait for its READY."""
        handle = self._start(name, role, **kw)
        try:
            self._wait_ready(handle)
        except BaseException:
            handle.kill()
            raise
        return handle

    def _start(self, name: str, role: str, *, store: str | None = None,
               workdir: str | None = None, shard: int = 0) -> NodeHandle:
        """Start one node's process; its port is known at its READY."""
        cmd = [sys.executable, "-m",
               "repro_torch.serve.cluster.shard_server", "--role", role,
               "--port", "0", "--device", self.device]
        if role == "primary":
            cmd += ["--store", store]
        elif role == "scorer":
            os.makedirs(workdir, exist_ok=True)
            cmd += ["--peer", self.primary.addr, "--shard", str(shard),
                    "--num-shards", str(self.num_scorers),
                    "--workdir", workdir]
        else:
            os.makedirs(os.path.dirname(store), exist_ok=True)
            cmd += ["--peer", self.primary.addr, "--store", store]
        if self.backend:
            cmd += ["--backend", self.backend]
        env = dict(os.environ)
        env["PYTHONPATH"] = _src_path() + os.pathsep + \
            env.get("PYTHONPATH", "")
        env["PYTHONUNBUFFERED"] = "1"
        log_path = os.path.join(self.root, "logs", f"{name}.log")
        with open(log_path, "ab") as log:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log,
                                    env=env, text=True)
        return NodeHandle(name, role, proc, None, log_path)

    @staticmethod
    def _wait_ready(handle: NodeHandle) -> None:
        """Read the node's stdout up to its ``READY <port>`` line; a node
        that exits first raises with the tail of its log."""
        deadline = time.monotonic() + _READY_TIMEOUT_S
        while True:
            line = handle.proc.stdout.readline()
            if line.startswith("READY "):
                handle.port = int(line.split()[1])
                return
            if handle.proc.poll() is not None or not line:
                with open(handle.log_path) as f:
                    tail = f.read()[-2000:]
                raise RuntimeError(f"shard server {handle.name} died "
                                   f"during startup:\n{tail}")
            if time.monotonic() > deadline:
                handle.kill()
                raise RuntimeError(f"shard server {handle.name} never "
                                   "reported READY")

    # -- topology ---------------------------------------------------------

    def router(self, **kw):
        """A fresh ``ClusterRouter`` over this cluster's endpoints."""
        from .router import ClusterRouter
        return ClusterRouter(self.primary.addr,
                             [s.addr for s in self.scorers],
                             [r.addr for r in self.replicas], **kw)

    def kill_primary(self) -> None:
        """SIGKILL the primary mid-whatever-it-was-doing — the failover
        suite's inciting incident.  The handle stays in the topology (a
        router holding its address gets ``ShardUnavailableError``); use
        ``ClusterRouter.failover()`` to promote a replica in its place."""
        self.primary.kill()

    def kill_scorer(self, i: int) -> None:
        """SIGKILL scorer ``i`` (it stays in the topology — routers that
        contact it get ``ShardUnavailableError`` and fail over)."""
        self.scorers[i].kill()

    def kill_replica(self, i: int) -> None:
        """SIGKILL replica ``i`` mid-whatever-it-was-doing."""
        self.replicas[i].kill()

    def restart_replica(self, i: int) -> NodeHandle:
        """Respawn replica ``i`` on its EXISTING store directory — the
        restart-mid-ingest recovery path: local snapshot + shipped WAL
        tail, then shipping resumes from the exact applied seq."""
        old = self.replicas[i]
        old.kill()
        self.replicas[i] = self._spawn(
            old.name, "replica",
            store=os.path.join(self.root, old.name, "store"))
        return self.replicas[i]

    def close(self) -> None:
        """SIGKILL every node still running (idempotent)."""
        for h in [*self.scorers, *self.replicas,
                  *([self.primary] if self.primary else [])]:
            try:
                h.kill()
            except Exception:
                pass

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
