"""filter_kubernetes — pod metadata enrichment.

The port's own copy of ``fluentbit_tpu/plugins/filter_kubernetes.py``
(reference: plugins/filter_kubernetes, kubernetes.c, kube_meta.c,
kube_property.c, kube_regex.h). The tag (the in_tail convention
``kube.var.log.containers.<pod>_<namespace>_<container>-<id>.log``)
gives the pod's identity through ``regex.FlbRegex``; a tag that does not
match passes untouched. Metadata comes from a TTL cache fed by a
pre-warmed directory of ``<namespace>_<pod>.meta`` JSON files
(``kube_meta_preload_cache_dir``, kube_meta.c:331-360) or by a GET
against ``kube_url`` (http or https with the service-account CA
``kube_ca_file`` and a bearer token from ``kube_token_file`` or
``kube_token_command``, refreshed every ``kube_token_ttl``, backing off
30 s after a failed refresh and re-read once on a 401;
kube_meta.c:101-191, 240-248). ``merge_log`` parses the ``log`` field,
trimmed, as JSON or through a named parser (``merge_parser``, the
port's ``parsers``) into the record, existing keys winning, or under
``merge_log_key`` (kubernetes.c:295-330). The pod annotations
``fluentbit.io/parser`` and ``fluentbit.io/exclude`` apply when
``k8s-logging.parser`` / ``k8s-logging.exclude`` are on
(kube_property.c).

Host work only: this filter launches nothing, and it cannot take the
raw chunk path, so a ``kube.*`` append reaches the filters after it
decoded (grep's device match included).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

from ..codec.events import LogEvent
from ..core.config import ConfigMapEntry
from ..core.plugin import FilterPlugin, FilterResult, registry
from ..regex import FlbRegex

log = logging.getLogger("flb.kube")

DEFAULT_TAG_PREFIX = "kube.var.log.containers."

#: `<pod>_<namespace>_<container>-<docker_id>.log` (kube_regex.h tag regex
#: shape, re-specified)
TAG_REGEX = (
    r"(?<pod_name>[a-z0-9](?:[-a-z0-9.]*[a-z0-9])?)_"
    r"(?<namespace_name>[^_]+)_"
    r"(?<container_name>.+)-(?<docker_id>[a-f0-9]{12,64})\.log$"
)


@registry.register
class KubernetesFilter(FilterPlugin):
    name = "kubernetes"
    description = "enrich records with Kubernetes pod metadata"
    config_map = [
        ConfigMapEntry("kube_tag_prefix", "str", default=DEFAULT_TAG_PREFIX),
        ConfigMapEntry("kube_url", "str"),
        ConfigMapEntry("kube_meta_preload_cache_dir", "str"),
        ConfigMapEntry("kube_meta_cache_ttl", "time", default="0"),
        ConfigMapEntry("regex_parser", "str"),
        ConfigMapEntry("merge_log", "bool", default=False),
        ConfigMapEntry("merge_log_key", "str"),
        ConfigMapEntry("merge_log_trim", "bool", default=True),
        ConfigMapEntry("merge_parser", "str"),
        ConfigMapEntry("keep_log", "bool", default=True),
        ConfigMapEntry("labels", "bool", default=True),
        ConfigMapEntry("annotations", "bool", default=True),
        ConfigMapEntry("k8s-logging.parser", "bool", default=False),
        ConfigMapEntry("k8s-logging.exclude", "bool", default=False),
        ConfigMapEntry("buffer_size", "str", default="32k"),
        ConfigMapEntry("tls.verify", "bool", default=True),
        ConfigMapEntry("use_kubelet", "bool", default=False),
        ConfigMapEntry("kube_ca_file", "str",
                       default="/var/run/secrets/kubernetes.io/"
                               "serviceaccount/ca.crt"),
        ConfigMapEntry("kube_token_file", "str",
                       default="/var/run/secrets/kubernetes.io/"
                               "serviceaccount/token"),
        ConfigMapEntry("kube_token_command", "str"),
        ConfigMapEntry("kube_token_ttl", "time", default="10m"),
    ]

    def init(self, instance, engine) -> None:
        self._engine = engine
        self._tag_rx = FlbRegex(TAG_REGEX)
        self._cache: Dict[Tuple[str, str], Tuple[float, dict]] = {}
        self._merge_parser = None
        self._token: Optional[str] = None
        self._token_created = 0.0
        self._token_retry_at = 0.0
        #: (records, host seconds) of each append, the most recent
        #: appends only
        self.step_seconds: collections.deque = collections.deque(
            maxlen=4096)
        if self.merge_parser:
            self._merge_parser = (engine.parsers if engine else {}).get(
                self.merge_parser
            )
            if self._merge_parser is None:
                raise ValueError(
                    f"kubernetes: unknown merge_parser {self.merge_parser!r}"
                )

    # -- identity + metadata --

    def tag_to_identity(self, tag: str) -> Optional[Dict[str, str]]:
        """kube.var.log.containers.<pod>_<ns>_<ctr>-<id>.log → fields."""
        rest = tag
        prefix = self.kube_tag_prefix or ""
        if prefix and rest.startswith(prefix):
            rest = rest[len(prefix):]
        return self._tag_rx.parse_record(rest)

    def _load_meta(self, namespace: str, pod: str) -> dict:
        key = (namespace, pod)
        hit = self._cache.get(key)
        now = time.monotonic()
        ttl = self.kube_meta_cache_ttl or 0
        if hit is not None and (ttl <= 0 or now - hit[0] < ttl):
            return hit[1]
        meta = {}
        if self.kube_meta_preload_cache_dir:
            path = os.path.join(self.kube_meta_preload_cache_dir,
                                f"{namespace}_{pod}.meta")
            try:
                with open(path, "r", encoding="utf-8") as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = {}
        if not meta and self.kube_url:
            meta = self._fetch_meta(namespace, pod)
        self._cache[key] = (now, meta)
        return meta

    def _auth_token(self) -> Optional[str]:
        """Service-account bearer token, refreshed every kube_token_ttl;
        a failed refresh keeps the stale token for 30 s before the next
        try (a hanging kube_token_command must not run on every cache
        miss)."""
        now = time.monotonic()
        ttl = self.kube_token_ttl or 600
        if self._token is not None and now - self._token_created < ttl:
            return self._token
        if now < self._token_retry_at:
            return self._token
        token = None
        if self.kube_token_command:
            import subprocess

            try:
                proc = subprocess.run(self.kube_token_command, shell=True,
                                      capture_output=True, timeout=10)
                if proc.returncode == 0 and proc.stdout.strip():
                    token = proc.stdout.strip().decode("utf-8", "replace")
                else:
                    log.warning("kubernetes: kube_token_command failed "
                                "rc=%d", proc.returncode)
            except (OSError, subprocess.TimeoutExpired) as e:
                log.warning("kubernetes: kube_token_command: %s", e)
        elif self.kube_token_file:
            try:
                with open(self.kube_token_file, encoding="utf-8") as f:
                    token = f.read().strip()
            except OSError:
                pass  # not in a cluster: an unauthenticated fetch
        if token:
            self._token = token
            self._token_created = now
            self._token_retry_at = 0.0
        else:
            self._token_retry_at = now + 30.0
        return self._token

    def _get(self, host: str, port: int, path: str, use_tls: bool,
             token: Optional[str], ca: Optional[str]):
        from ..utils import sync_http_request

        headers = {"Authorization": f"Bearer {token}"} if token else {}
        return sync_http_request(
            host, port, "GET", path, headers=headers, timeout=3,
            tls=use_tls, tls_verify=bool(self.tls_verify), tls_ca_file=ca)

    def _fetch_meta(self, namespace: str, pod: str) -> dict:
        """Blocking GET of the pod object
        (/api/v1/namespaces/<ns>/pods/<pod>), over https with the
        service-account CA and bearer token when kube_url is https."""
        url = self.kube_url.rstrip("/")
        use_tls = url.startswith("https://")
        if not use_tls and not url.startswith("http://"):
            log.warning("kubernetes: kube_url must be http(s)://")
            return {}
        hostport = url.split("://", 1)[1].split("/")[0]
        host, _, port = hostport.partition(":")
        try:
            port_n = int(port or (443 if use_tls else 80))
        except ValueError:
            log.warning("kubernetes: malformed kube_url port %r", port)
            return {}
        path = f"/api/v1/namespaces/{namespace}/pods/{pod}"
        token = self._auth_token()
        ca = self.kube_ca_file if (self.kube_ca_file
                                   and os.path.exists(self.kube_ca_file)) \
            else None
        got = self._get(host, port_n, path, use_tls, token, ca)
        if got is None:
            return {}
        status, _hdrs, body = got
        if status == 401 and token:
            # the token rotated: refresh now (the 401 lifts the back-off)
            # and retry once
            self._token = None
            self._token_created = 0.0
            self._token_retry_at = 0.0
            token = self._auth_token()
            if token:
                got = self._get(host, port_n, path, use_tls, token, ca)
                if got is None:
                    return {}
                status, _hdrs, body = got
        if status != 200:
            return {}
        try:
            return json.loads(body)
        except ValueError:
            return {}

    def _kubernetes_map(self, identity: dict, meta: dict) -> dict:
        k8s: Dict[str, Any] = {
            "pod_name": identity["pod_name"],
            "namespace_name": identity["namespace_name"],
            "container_name": identity["container_name"],
            "docker_id": identity["docker_id"],
        }
        md = meta.get("metadata", {}) if isinstance(meta, dict) else {}
        spec = meta.get("spec", {}) if isinstance(meta, dict) else {}
        if md.get("uid"):
            k8s["pod_id"] = md["uid"]
        if spec.get("nodeName"):
            k8s["host"] = spec["nodeName"]
        if self.labels and md.get("labels"):
            k8s["labels"] = md["labels"]
        if self.annotations and md.get("annotations"):
            k8s["annotations"] = md["annotations"]
        return k8s

    def _pod_properties(self, meta: dict) -> dict:
        """fluentbit.io/* annotations gated by the k8s-logging.* options."""
        out = {}
        anns = (meta.get("metadata", {}) or {}).get("annotations", {}) \
            if isinstance(meta, dict) else {}
        if not isinstance(anns, dict):
            return out
        if self.k8s_logging_parser:
            p = anns.get("fluentbit.io/parser")
            if p:
                out["parser"] = p
        if self.k8s_logging_exclude:
            ex = str(anns.get("fluentbit.io/exclude", "")).lower()
            if ex in ("true", "on", "1", "yes"):
                out["exclude"] = True
        return out

    # -- merge_log --

    def _merge(self, ev: LogEvent, props: dict) -> Optional[dict]:
        """Parse the log field into structured fields; returns the new
        body, or None when nothing merged."""
        content = ev.body.get("log")
        if not isinstance(content, str):
            return None
        if self.merge_log_trim:
            content = content.rstrip()
        parsed = None
        parser = self._merge_parser
        pname = props.get("parser")
        if pname and self._engine is not None:
            parser = self._engine.parsers.get(pname, parser)
        if parser is not None:
            got = parser.do(content)
            if got is not None:
                parsed = got[0]
        elif content[:1] == "{":
            try:
                obj = json.loads(content)
                if isinstance(obj, dict):
                    parsed = obj
            except ValueError:
                parsed = None
        if parsed is None:
            return None
        body = dict(ev.body)
        if not self.keep_log:
            body.pop("log", None)
        if self.merge_log_key:
            body[self.merge_log_key] = parsed
        else:
            for k, v in parsed.items():
                body.setdefault(k, v)
        return body

    # -- the filter --

    def filter(self, events: list, tag: str, engine) -> tuple:
        t0 = time.perf_counter()
        try:
            return self._filter(events, tag)
        finally:
            self.step_seconds.append((len(events),
                                      time.perf_counter() - t0))

    def _filter(self, events: list, tag: str) -> tuple:
        identity = self.tag_to_identity(tag)
        if identity is None:
            return (FilterResult.NOTOUCH, events)
        meta = self._load_meta(identity["namespace_name"],
                               identity["pod_name"])
        k8s = self._kubernetes_map(identity, meta)
        props = self._pod_properties(meta)
        if props.get("exclude"):
            return (FilterResult.MODIFIED, [])
        out = []
        for ev in events:
            if not isinstance(ev.body, dict):
                out.append(ev)
                continue
            body = (self._merge(ev, props) if self.merge_log else None) \
                or dict(ev.body)
            body["kubernetes"] = k8s
            out.append(LogEvent(timestamp=ev.timestamp, body=body,
                                metadata=ev.metadata, raw=None))
        return (FilterResult.MODIFIED, out)
