"""A cluster of this package's daemons, each a process of its own,
configured through this package's CLI.

Each daemon is `python -m garage_tpu_torch.cli -c <dir>/garage.toml
server` (fork and exec: nothing of the caller's CUDA state is shared),
with fixed loopback ports (the CLI reads its daemon's RPC address from
the config, so port 0 cannot be used).  `tests/test_torch_daemon.py`
and `chip_smoke.py` drive their daemons through this module:

    daemons = [Daemon(root, i, ports[i], ...) for i in range(n)]
    for d in daemons:
        d.start()
    for d in daemons:
        d.wait_up(60)
    key_id, secret = configure(daemons, "bucket")   # every step a CLI process
    ...
    codes = stop_all(daemons, 30)                   # SIGTERM; exit codes

`kill_all` (for a `finally`) ends whatever is still running.
"""

from __future__ import annotations

import os
import re
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # where `garage_tpu_torch` lies
RPC_SECRET = "7f" * 32
ADMIN_TOKEN = "daemon-admin-token"
METRICS_TOKEN = "daemon-metrics-token"
WEB_ROOT = "web.garage"
UP_LINE = re.compile(r"^garage-tpu node ([0-9a-f]{64}) up$", re.M)


def _toml(v) -> str:
    """A TOML value: a string, a bool, a number or a list of strings."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml(x) for x in v) + "]"
    return repr(v)


def free_ports(n: int) -> list[int]:
    """`n` distinct loopback ports that were free a moment ago."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@dataclass
class Daemon:
    """One daemon: its directory, config, ports and process.  The S3,
    K2V and website servers are on when their port is given; the admin
    API always is."""

    root: Path
    index: int
    rpc_port: int
    admin_port: int
    mode: str | None = "ec:2:1"  # None: one copy of each block (replication_factor 1)
    block_size: int = 65536
    cpu: bool = False  # True: [tpu] enable = false, the kernels' plain versions
    engine: str = "sqlite"  # db_engine: "sqlite", "log", "native" or "memory"
    s3_port: int | None = None
    k2v_port: int | None = None
    web_port: int | None = None
    extra: dict[str, dict] = field(default_factory=dict)  # more keys, by config section
    peers: list[str] = field(default_factory=list)  # bootstrap_peers: "<id>@<host>:<port>"
    module: str = "garage_tpu_torch.cli"
    node_key: bytes | None = field(default=None, repr=False)  # 32 bytes: fixes the node id
    proc: subprocess.Popen | None = field(default=None, repr=False)
    node_id: str = ""
    _log_from: int = field(default=0, repr=False)  # where the current process's output starts

    @property
    def dir(self) -> Path:
        return self.root / f"node{self.index}"

    @property
    def config(self) -> Path:
        return self.dir / "garage.toml"

    @property
    def log(self) -> Path:
        return self.dir / "daemon.log"

    @property
    def rpc_addr(self) -> str:
        return f"127.0.0.1:{self.rpc_port}"

    def url(self, port: int) -> str:
        return f"http://127.0.0.1:{port}"

    def write_config(self) -> Path:
        """The daemon's TOML, and its node key when one is given and the
        node has none yet."""
        (self.dir / "meta").mkdir(parents=True, exist_ok=True)
        keyfile = self.dir / "meta" / "node_key"
        if self.node_key is not None and not keyfile.exists():
            keyfile.write_bytes(self.node_key)
            keyfile.chmod(0o600)
        top = {"metadata_dir": str(self.dir / "meta"), "data_dir": str(self.dir / "data"),
               "db_engine": self.engine, "block_size": self.block_size,
               "rpc_bind_addr": self.rpc_addr, "rpc_public_addr": self.rpc_addr,
               "rpc_secret": RPC_SECRET, "bootstrap_peers": self.peers}
        if self.mode:
            top["replication_mode"] = self.mode
        else:
            top["replication_factor"] = 1
        sections = {"admin": {"api_bind_addr": f"127.0.0.1:{self.admin_port}",
                              "admin_token": ADMIN_TOKEN, "metrics_token": METRICS_TOKEN}}
        if self.s3_port:
            sections["s3_api"] = {"api_bind_addr": f"127.0.0.1:{self.s3_port}",
                                  "s3_region": "garage"}
        if self.k2v_port:
            sections["k2v_api"] = {"api_bind_addr": f"127.0.0.1:{self.k2v_port}"}
        if self.web_port:
            sections["s3_web"] = {"bind_addr": f"127.0.0.1:{self.web_port}",
                                  "root_domain": f".{WEB_ROOT}"}
        if self.cpu:
            sections["tpu"] = {"enable": False}
        for name, keys in self.extra.items():
            sections.setdefault(name, {}).update(keys)
        lines = [f"{k} = {_toml(v)}" for k, v in top.items()]
        for name, keys in sections.items():
            lines += [f"[{name}]"] + [f"{k} = {_toml(v)}" for k, v in keys.items()]
        self.config.write_text("\n".join(lines) + "\n")
        return self.config

    def start(self, env: dict | None = None) -> None:
        """Write the config and start the daemon; its output goes to
        `log` (appended across restarts)."""
        self.write_config()
        self._log_from = self.log.stat().st_size if self.log.exists() else 0
        with open(self.log, "a") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", self.module, "-c", str(self.config), "server"],
                stdout=out, stderr=subprocess.STDOUT, cwd=ROOT,
                env={**os.environ, **(env or {})})

    def wait_up(self, timeout: float) -> str:
        """Wait for the "up" line of the daemon's current process (printed
        once every server listens); its node id.  Raises with the log's
        tail if the daemon exits or the time runs out."""
        deadline = time.monotonic() + timeout
        while True:
            with open(self.log, "rb") as f:
                f.seek(self._log_from)
                m = UP_LINE.findall(f.read().decode(errors="replace"))
            if m:
                self.node_id = m[-1]
                return self.node_id
            if self.proc.poll() is not None:
                raise RuntimeError(f"daemon {self.index} exited with {self.proc.returncode}:\n"
                                   f"{self.tail()}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"daemon {self.index} not up after {timeout} s:\n"
                                   f"{self.tail()}")
            time.sleep(0.1)

    def tail(self, n: int = 30) -> str:
        if not self.log.exists():
            return ""
        return "\n".join(self.log.read_text().splitlines()[-n:])

    def stop(self, timeout: float) -> int:
        """SIGTERM, then the exit code (`None` past `timeout`)."""
        if self.proc is None or self.proc.poll() is not None:
            return self.proc.returncode if self.proc else 0
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)


CLI_WALLS: list[tuple[str, float]] = []  # (command, seconds) of every `cli` call


CLI_TIMEOUT_S = 120


def cli(cfg: Path, *args: str, module: str = "garage_tpu_torch.cli") -> str:
    """One CLI process against the daemon of config `cfg`; its standard
    output.  Raises with both outputs when it exits non-zero.  Its wall
    time is appended to `CLI_WALLS`."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, "-c", str(cfg), *args],
                       capture_output=True, text=True, timeout=CLI_TIMEOUT_S, cwd=ROOT)
    CLI_WALLS.append((" ".join(args[:2]), time.perf_counter() - t0))
    if r.returncode != 0:
        raise RuntimeError(f"cli {' '.join(args)} exited {r.returncode}:\n{r.stdout}\n{r.stderr}")
    return r.stdout.strip()


def cli_many(calls: list[tuple]) -> list[str]:
    """Independent CLI calls `(cfg, *args)`, all started together, each a
    process of its own; their outputs in order."""
    with ThreadPoolExecutor(len(calls)) as pool:
        return list(pool.map(lambda c: cli(*c), calls))


def configure(daemons: list[Daemon], bucket: str, website: bool = False) -> tuple[str, str]:
    """The operator's steps, each a CLI process, as a new cluster needs
    them: `node id` of every daemon; `node connect` of every other daemon
    from daemon 0; `layout assign` of each, one zone per daemon, 1G;
    `layout apply`; `key new`; `bucket create`; `bucket allow` (read,
    write, owner); and `bucket website --allow` when asked.  Independent
    calls run side by side.  Returns (key id, secret)."""
    first = daemons[0].config
    ids = cli_many([(d.config, "node", "id") for d in daemons])
    for d, out in zip(daemons, ids):
        nid, addr = out.split("@")
        if d.node_id:
            assert nid == d.node_id, (nid, d.node_id)
        d.node_id = nid
    cli_many([(first, "node", "connect", out) for out in ids[1:]])
    cli_many([(first, "layout", "assign", d.node_id, "-z", f"z{d.index}", "-s", "1G")
              for d in daemons])
    out = cli(first, "layout", "apply")
    if "applied" not in out:
        raise RuntimeError(f"layout apply: {out}")
    out = cli(first, "key", "new", "--name", f"{bucket}-key")
    key_id = out.split("Key ID: ")[1].splitlines()[0].strip()
    secret = out.split("Secret key: ")[1].splitlines()[0].strip()
    cli(first, "bucket", "create", bucket)
    steps = [(first, "bucket", "allow", bucket, "--key", key_id, "--read", "--write", "--owner")]
    if website:
        steps.append((first, "bucket", "website", bucket, "--allow"))
    cli_many(steps)
    return key_id, secret


def stop_all(daemons: list[Daemon], timeout: float) -> list[int | None]:
    """SIGTERM to every running daemon at once, then each daemon's exit
    code, in order (`None` for one still running after `timeout`)."""
    for d in daemons:
        if d.proc is not None and d.proc.poll() is None:
            d.proc.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout
    codes = []
    for d in daemons:
        try:
            codes.append(d.proc.wait(max(0.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    return codes


def kill_all(daemons: list[Daemon]) -> None:
    for d in daemons:
        d.kill()


SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{([^}]*)\})?\s+(\S+)$")
LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def metric_samples(text: str, family: str) -> list[tuple[dict, float]]:
    """The samples of `family` in a Prometheus exposition: (labels,
    value) pairs."""
    out = []
    for line in text.splitlines():
        m = SAMPLE.match(line.strip())
        if m and m.group(1) == family:
            out.append((dict(LABEL.findall(m.group(2) or "")), float(m.group(3))))
    return out
