"""External peer-discovery publishers: Consul + Kubernetes.

Reference src/rpc/consul.rs (ConsulDiscovery: catalog/agent APIs) and
src/rpc/kubernetes.rs (GarageNode custom resources).  Each publisher can
(a) advertise this node's (public key, rpc address) and (b) list the
other advertised nodes; the System discovery loop connects to whatever
comes back.  Plain aiohttp against the services' REST APIs — no vendored
clients.
"""

from __future__ import annotations

import json
import logging
import socket

logger = logging.getLogger("garage.discovery")

META_PREFIX = "garage-tpu"


class ConsulDiscovery:
    """Publish/fetch via a Consul server (reference consul.rs:76-230).

    api = "agent"  -> PUT /v1/agent/service/register (local agent)
    api = "catalog"-> PUT /v1/catalog/register (direct catalog write)
    reads always use GET /v1/catalog/service/{service_name}.
    """

    def __init__(self, cfg):
        self.addr = cfg.consul_http_addr.rstrip("/")
        self.service_name = cfg.service_name
        self.api = cfg.api
        self.token = cfg.token
        self.tags = list(cfg.tags or [])
        self.meta = dict(cfg.meta or {})
        # TLS knobs (reference config.rs ConsulDiscoveryConfig + consul.rs
        # client builder): private CA, mutual-TLS client cert, skip-verify
        self.ca_cert = cfg.ca_cert
        self.client_cert = cfg.client_cert
        self.client_key = cfg.client_key
        self.tls_skip_verify = cfg.tls_skip_verify
        self._session = None

    def _ssl(self):
        """ssl.SSLContext for the consul endpoint, or None for defaults."""
        if not (self.ca_cert or self.client_cert or self.tls_skip_verify):
            return None
        import ssl

        ctx = ssl.create_default_context(cafile=self.ca_cert)
        if self.client_cert:
            ctx.load_cert_chain(self.client_cert, self.client_key)
        if self.tls_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    def _sess(self):
        import aiohttp

        if self._session is None or self._session.closed:
            headers = {}
            if self.token:
                headers["x-consul-token"] = self.token
            ssl_ctx = self._ssl()
            connector = (
                aiohttp.TCPConnector(ssl=ssl_ctx) if ssl_ctx is not None else None
            )
            self._session = aiohttp.ClientSession(
                headers=headers, connector=connector
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def get_nodes(self) -> list[tuple[bytes, tuple[str, int]]]:
        url = f"{self.addr}/v1/catalog/service/{self.service_name}"
        async with self._sess().get(url) as resp:
            resp.raise_for_status()
            entries = await resp.json()
        out = []
        for ent in entries:
            meta = ent.get("ServiceMeta") or {}
            pubkey = meta.get(f"{META_PREFIX}-pubkey")
            ip = ent.get("ServiceAddress") or ent.get("Address")
            port = ent.get("ServicePort")
            if not (pubkey and ip and port):
                logger.warning("malformed consul node spec: %r", ent)
                continue
            try:
                out.append((bytes.fromhex(pubkey), (ip, int(port))))
            except ValueError:
                logger.warning("bad pubkey from consul: %r", pubkey)
        return out

    async def publish(self, node_id: bytes, rpc_addr: tuple[str, int]) -> None:
        hostname = socket.gethostname()
        node = f"garage:{node_id.hex()[:16]}"
        meta = dict(self.meta)
        meta[f"{META_PREFIX}-pubkey"] = node_id.hex()
        meta[f"{META_PREFIX}-hostname"] = hostname
        tags = ["advertised-by-garage-tpu", hostname, *self.tags]
        if self.api == "catalog":
            url = f"{self.addr}/v1/catalog/register"
            body = {
                "Node": node,
                "Address": rpc_addr[0],
                "Service": {
                    "ID": node,
                    "Service": self.service_name,
                    "Tags": tags,
                    "Meta": meta,
                    "Address": rpc_addr[0],
                    "Port": rpc_addr[1],
                },
            }
        else:
            url = f"{self.addr}/v1/agent/service/register?replace-existing-checks"
            body = {
                "ID": node,
                "Name": self.service_name,
                "Tags": tags,
                "Meta": meta,
                "Address": rpc_addr[0],
                "Port": rpc_addr[1],
            }
        async with self._sess().put(url, json=body) as resp:
            resp.raise_for_status()


class KubernetesDiscovery:
    """Publish/fetch via GarageNode custom resources in the cluster API
    (reference kubernetes.rs:1-114).  Runs in-cluster: credentials come
    from the mounted service account unless overridden (tests point
    api_server at a mock and set token/verify off)."""

    GROUP = "deuxfleurs.fr"
    VERSION = "v1"
    PLURAL = "garagenodes"

    def __init__(self, cfg):
        self.namespace = cfg.namespace
        self.service_name = cfg.service_name
        self.skip_crd = cfg.skip_crd
        sa = "/var/run/secrets/kubernetes.io/serviceaccount"
        self.api_server = cfg.api_server or "https://kubernetes.default.svc"
        self.token = cfg.token
        self.ca_cert: str | None = None
        if cfg.token is None:
            try:
                with open(f"{sa}/token") as f:
                    self.token = f.read().strip()
                self.ca_cert = f"{sa}/ca.crt"
            except OSError:
                self.token = None
        self._session = None

    def _sess(self):
        import aiohttp
        import ssl

        if self._session is None or self._session.closed:
            headers = {}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            ssl_ctx = None
            if self.api_server.startswith("https") and self.ca_cert:
                ssl_ctx = ssl.create_default_context(cafile=self.ca_cert)
            self._session = aiohttp.ClientSession(
                headers=headers,
                connector=aiohttp.TCPConnector(ssl=ssl_ctx)
                if ssl_ctx is not None
                else None,
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    def _base(self) -> str:
        return (
            f"{self.api_server}/apis/{self.GROUP}/{self.VERSION}"
            f"/namespaces/{self.namespace}/{self.PLURAL}"
        )

    async def get_nodes(self) -> list[tuple[bytes, tuple[str, int]]]:
        sel = f"garage.{self.GROUP}/service={self.service_name}"
        async with self._sess().get(
            self._base(), params={"labelSelector": sel}
        ) as resp:
            resp.raise_for_status()
            data = await resp.json()
        out = []
        for item in data.get("items", []):
            name = (item.get("metadata") or {}).get("name", "")
            spec = item.get("spec") or {}
            ip, port = spec.get("address"), spec.get("port")
            if not (name and ip and port):
                logger.warning("malformed GarageNode: %r", item)
                continue
            try:
                out.append((bytes.fromhex(name), (ip, int(port))))
            except ValueError:
                logger.warning("bad GarageNode name (want hex pubkey): %r", name)
        return out

    async def publish(self, node_id: bytes, rpc_addr: tuple[str, int]) -> None:
        name = node_id.hex()
        body = {
            "apiVersion": f"{self.GROUP}/{self.VERSION}",
            "kind": "GarageNode",
            "metadata": {
                "name": name,
                "labels": {
                    f"garage.{self.GROUP}/service": self.service_name,
                },
            },
            "spec": {
                "hostname": socket.gethostname(),
                "address": rpc_addr[0],
                "port": rpc_addr[1],
            },
        }
        # server-side apply: one PATCH upserts (create or update)
        url = f"{self._base()}/{name}?fieldManager=garage-tpu&force=true"
        async with self._sess().patch(
            url,
            data=json.dumps(body),
            headers={"Content-Type": "application/apply-patch+yaml"},
        ) as resp:
            resp.raise_for_status()


def discovery_from_config(config) -> list:
    out = []
    if getattr(config, "consul_discovery", None) is not None:
        out.append(ConsulDiscovery(config.consul_discovery))
    if getattr(config, "kubernetes_discovery", None) is not None:
        out.append(KubernetesDiscovery(config.kubernetes_discovery))
    return out
