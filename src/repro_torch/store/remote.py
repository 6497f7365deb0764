"""Range-read remote object-store backend (paper §2.1 "shared storage").

Production fleets keep expert checkpoints in object storage with
HTTP/S3-style semantics: ``GET`` with a byte range, ``HEAD`` for
metadata, immutable-once-published objects, per-request latency, and
transient faults.  :class:`RemoteObjectStore` emulates exactly that
surface over a local directory so every test and benchmark runs without
a network while exercising the real failure modes:

* **latency / bandwidth** — each data request sleeps
  ``latency_s + nbytes / bandwidth`` (``RemoteProfile``), making remote
  round trips genuinely expensive relative to local reads, so the
  tiered cache's wins are measurable in wall time, not just counters;
* **fault injection** — ``fail_every=N`` fails every Nth data request,
  ``inject_faults(n)`` fails the next *n*; both raise
  :class:`RemoteError` *before* any bytes move, like a dropped
  connection.  :class:`RetryPolicy` gives readers bounded retry with
  exponential backoff;
* **request accounting** — requests / bytes / faults counters per store,
  shared by every reader of the same endpoint (wired through
  ``CheckpointStore.remote_store``), so tests can assert "one fill, no
  double fetch" directly.

Layout of a bucket (one directory):

    <root>/<model_id>/MODEL.json       # same manifest as a local model
    <root>/<model_id>/tensors/*.bin    # raw tensor bytes

i.e. ``publish_model`` uploads a model verbatim — a real S3/HTTP
backend only needs to implement ``get_range``/``head`` against the same
keys.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional

# RetryPolicy grew up and moved out (shared by tiered reads, cache fills,
# and the service's executor-level retry); re-exported for compatibility.
from repro_torch.store.retry import RetryPolicy  # noqa: F401
from repro_torch.store.tensorstore import MODEL_MANIFEST, CheckpointStore
from repro_torch.testing.chaos import chaos_corrupt


class RemoteError(IOError):
    """A remote request failed (injected fault or missing object)."""


@dataclasses.dataclass(frozen=True)
class RemoteProfile:
    """Latency/bandwidth/fault shape of an emulated remote endpoint.

    ``latency_s`` is per-request fixed cost (the dominant term for small
    reads — why coalescing and caching matter); ``mbps`` throttles
    payload bytes (0 = unthrottled); ``fail_every`` fails every Nth data
    request (0 = never).
    """

    latency_s: float = 0.0
    mbps: float = 0.0
    fail_every: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(doc: Optional[Dict]) -> "RemoteProfile":
        doc = doc or {}
        return RemoteProfile(
            latency_s=float(doc.get("latency_s", 0.0)),
            mbps=float(doc.get("mbps", 0.0)),
            fail_every=int(doc.get("fail_every", 0)),
        )


class RemoteObjectStore:
    """Emulated object store: ranged GETs over immutable keys.

    Thread-safe; one instance per endpoint is shared across readers so
    the counters and the fault-injection schedule are coherent.
    """

    def __init__(self, root: str, profile: Optional[RemoteProfile] = None):
        self.root = os.path.abspath(root)
        self.profile = profile or RemoteProfile()
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.requests = 0
        self.bytes_served = 0
        self.faults_injected = 0
        self._fail_next = 0

    # -- fault injection ---------------------------------------------------
    def inject_faults(self, n: int) -> None:
        """Fail the next ``n`` data requests with :class:`RemoteError`."""
        with self._lock:
            self._fail_next += int(n)

    def _admit_request(self) -> None:
        """Count one data request; raise if a fault is scheduled."""
        with self._lock:
            self.requests += 1
            fail = False
            if self._fail_next > 0:
                self._fail_next -= 1
                fail = True
            elif self.profile.fail_every and (
                self.requests % self.profile.fail_every == 0
            ):
                fail = True
            if fail:
                self.faults_injected += 1
        if fail:
            raise RemoteError(f"injected remote fault (request #{self.requests})")

    def _throttle(self, nbytes: int) -> None:
        delay = self.profile.latency_s
        if self.profile.mbps:
            delay += nbytes / (self.profile.mbps * 1e6)
        if delay > 0:
            time.sleep(delay)

    # -- object surface ----------------------------------------------------
    def _path(self, key: str) -> str:
        path = os.path.abspath(os.path.join(self.root, key))
        if not path.startswith(self.root + os.sep):
            raise RemoteError(f"key escapes bucket root: {key!r}")
        return path

    def put_object(self, key: str, data: bytes) -> None:
        """Upload (atomic publish — a reader never sees a torn object)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        # chaos-ok: PUT atomicity is the object store's contract (this
        # class emulates S3-style semantics); failure injection for the
        # remote path goes through inject_faults, not the chaos harness
        os.replace(tmp, path)

    def head(self, key: str) -> Dict:
        """Metadata request: size + etag. Not subject to fault injection
        (control-plane requests are cheap and idempotent)."""
        try:
            st = os.stat(self._path(key))
        except FileNotFoundError:
            raise RemoteError(f"no such remote object: {key!r}") from None
        return {"size": st.st_size, "etag": f"{st.st_size}-{st.st_mtime_ns}"}

    def get_range(self, key: str, offset: int = 0, nbytes: Optional[int] = None) -> bytes:
        """Ranged GET. ``nbytes=None`` fetches to end-of-object."""
        self._admit_request()
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read() if nbytes is None else f.read(nbytes)
        except FileNotFoundError:
            raise RemoteError(f"no such remote object: {key!r}") from None
        if nbytes is not None and len(data) != nbytes:
            raise RemoteError(
                f"range [{offset}:{offset + nbytes}] out of bounds for {key!r}"
            )
        # wire bit-rot happens after the server's own length check: a
        # corrupt payload arrives with plausible framing and only the
        # verify-on-read contract (repro_torch.store.integrity) catches it
        data = chaos_corrupt("remote:get", data)
        self._throttle(len(data))
        with self._lock:
            self.bytes_served += len(data)
        return data

    def list_keys(self, prefix: str = "") -> List[str]:
        keys = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fname in files:
                if fname.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fname), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    keys.append(key)
        return sorted(keys)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "requests": self.requests,
                "bytes_served": self.bytes_served,
                "faults_injected": self.faults_injected,
            }


def model_key(model_id: str, rel_file: str) -> str:
    """Bucket key for one file of a published model."""
    return f"{model_id}/{rel_file.replace(os.sep, '/')}"


def publish_model(
    store: CheckpointStore, model_id: str, remote: RemoteObjectStore
) -> List[str]:
    """Upload a locally stored model (manifest + tensor files) to the
    bucket under ``<model_id>/...``.  Returns the uploaded keys."""
    mdir = os.path.join(store.root, model_id)
    manifest_path = os.path.join(mdir, MODEL_MANIFEST)
    with open(manifest_path, "rb") as f:
        raw_manifest = f.read()
    store.stats.record_read("meta", len(raw_manifest))
    import json

    doc = json.loads(raw_manifest)
    keys: List[str] = []
    for spec in doc["tensors"].values():
        with open(os.path.join(mdir, spec["file"]), "rb") as f:
            data = f.read()
        store.stats.record_read("meta", len(data))
        key = model_key(model_id, spec["file"])
        remote.put_object(key, data)
        keys.append(key)
    mkey = model_key(model_id, MODEL_MANIFEST)
    remote.put_object(mkey, raw_manifest)  # manifest last: publish point
    keys.append(mkey)
    return keys
