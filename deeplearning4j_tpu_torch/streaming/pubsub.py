"""Tensor pub-sub streaming — the reference's Kafka/Camel transport role.

Parity targets: dl4j-streaming's Kafka NDArray pipeline —
``deeplearning4j-scaleout/dl4j-streaming/src/main/java/org/deeplearning4j/
streaming/kafka/NDArrayPublisher.java`` (serialize INDArray → Kafka topic),
``NDArrayConsumer.java`` (topic → INDArray), and the Camel routes that
feed training from a stream.

The port of ``deeplearning4j_tpu/streaming/pubsub.py``, a copy: the
transport is host code.  The framing is the reference's byte for byte,
so a publisher of either package feeds a subscriber of the other; a
tensor (on any device) is published as its host copy, and the streaming
iterator yields the port's ``DataSet`` of numpy arrays, which a network
moves to its device.

The broker is a stdlib TCP server speaking
length-prefixed ``.npy`` frames — no Kafka cluster, no external daemon,
same topology (N publishers → topic → N subscribers, fan-out to all
subscribers of a topic).  The wire format is numpy's own serialization,
so any language with an npy reader interoperates.  For training ingest,
``StreamingDataSetIterator`` pairs a features topic with a labels topic
the way the reference's Camel route assembles DataSets.

Frame protocol (all little-endian):
  publisher → broker:  b"P" + u32 topic_len + topic + frames
  subscriber → broker: b"S" + u32 topic_len + topic, then reads frames
  frame: u64 payload_len + payload (npy bytes)
"""

from __future__ import annotations

import io
import logging
import queue
import socket
import struct
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator

logger = logging.getLogger(__name__)

_LEN = struct.Struct("<Q")
_U32 = struct.Struct("<I")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    return _recv_exact(sock, n)


def _array_to_bytes(arr) -> bytes:
    if hasattr(arr, "detach"):          # a tensor: its host copy
        arr = arr.detach().cpu().numpy()
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def _bytes_to_array(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


class _Subscriber:
    """One subscriber socket behind a bounded frame queue + writer thread.

    Publishers enqueue; a single writer thread owns the socket, so frames
    from concurrent publishers can never interleave mid-``sendall``.
    Delivery is LOSSLESS: when a subscriber's queue fills, ``offer``
    blocks the relaying publisher (the same backpressure the previous
    direct-``sendall`` design got from TCP) — dropping frames would
    silently skew zipped-topic consumers like StreamingDataSetIterator's
    features/labels pairing.  The queue still softens head-of-line
    blocking: a slow subscriber delays the topic only once it falls
    ``max_queue`` frames behind, instead of immediately.
    """

    def __init__(self, sock: socket.socket, max_queue: int = 256):
        self.sock = sock
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(max_queue)
        self.alive = True
        threading.Thread(target=self._writer, daemon=True).start()

    def offer(self, frame: bytes) -> None:
        while self.alive:
            try:
                self._q.put(frame, timeout=0.1)  # recheck alive while full
                return
            except queue.Full:
                continue

    def _writer(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None:
                break
            try:
                _send_frame(self.sock, frame)
            except OSError:
                break
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self.alive = False
        try:
            self._q.put_nowait(None)
        except queue.Full:
            self.sock.close()  # writer will die on next send


class TensorBroker:
    """In-process topic broker (the Kafka cluster's role, one process).

    >>> broker = TensorBroker().start()          # port auto-assigned
    >>> pub = NDArrayPublisher(broker.address, "features").connect()
    >>> sub = NDArrayConsumer(broker.address, "features").connect()
    >>> pub.publish(np.ones((2, 3)))
    >>> sub.next()                              # → the array
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._srv: Optional[socket.socket] = None
        self._subs: Dict[str, List[_Subscriber]] = {}
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._running = False

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def start(self) -> "TensorBroker":
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, self.port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen()
        self._running = True
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        role = None
        try:
            role = _recv_exact(conn, 1)
            tlen_raw = _recv_exact(conn, _U32.size)
            if role is None or tlen_raw is None:
                return
            (tlen,) = _U32.unpack(tlen_raw)
            topic_raw = _recv_exact(conn, tlen)
            if topic_raw is None:
                return
            topic = topic_raw.decode()
            if role == b"S":
                with self._lock:
                    self._subs.setdefault(topic, []).append(_Subscriber(conn))
                return  # frames are pushed by publishers; keep socket open
            while True:  # publisher: relay frames to every subscriber
                frame = _recv_frame(conn)
                if frame is None:
                    return
                with self._lock:
                    subs = list(self._subs.get(topic, []))
                    dead = [s for s in subs if not s.alive]
                    if dead:
                        self._subs[topic] = [s for s in subs if s.alive]
                for d in dead:
                    # visible trail for lossless-delivery debugging: frames
                    # queued at subscriber death are discarded, and offer()
                    # silently skips culled subscribers
                    pending = d._q.qsize()
                    logger.info(
                        "pubsub: culled dead subscriber on topic %r "
                        "(%d queued frame(s) discarded)", topic, pending)
                for s in subs:
                    s.offer(frame)
        finally:
            if role == b"P":
                conn.close()

    def stop(self) -> None:
        self._running = False
        if self._srv is not None:
            self._srv.close()
        with self._lock:
            for subs in self._subs.values():
                for s in subs:
                    s.close()
                    s.sock.close()
            self._subs.clear()


class NDArrayPublisher:
    """Publish numpy arrays or tensors to a broker topic (reference
    NDArrayPublisher.java: INDArray → serialized bytes → topic)."""

    def __init__(self, address: Tuple[str, int], topic: str):
        self.address = address
        self.topic = topic
        self._sock: Optional[socket.socket] = None

    def connect(self) -> "NDArrayPublisher":
        self._sock = socket.create_connection(self.address)
        t = self.topic.encode()
        self._sock.sendall(b"P" + _U32.pack(len(t)) + t)
        return self

    def publish(self, arr) -> None:
        if self._sock is None:
            raise RuntimeError("connect() first")
        _send_frame(self._sock, _array_to_bytes(arr))

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class NDArrayConsumer:
    """Subscribe to a broker topic and read arrays (reference
    NDArrayConsumer.java).  Frames received on a background thread queue
    up; ``next()`` blocks with an optional timeout."""

    def __init__(self, address: Tuple[str, int], topic: str,
                 max_queue: int = 1024):
        self.address = address
        self.topic = topic
        self._sock: Optional[socket.socket] = None
        self._q: "queue.Queue[Optional[np.ndarray]]" = queue.Queue(max_queue)

    def connect(self) -> "NDArrayConsumer":
        self._sock = socket.create_connection(self.address)
        t = self.topic.encode()
        self._sock.sendall(b"S" + _U32.pack(len(t)) + t)
        threading.Thread(target=self._pump, daemon=True).start()
        return self

    def _pump(self) -> None:
        while True:
            try:
                frame = _recv_frame(self._sock)
            except OSError:
                frame = None
            if frame is None:
                self._q.put(None)  # end-of-stream marker
                return
            self._q.put(_bytes_to_array(frame))

    def next(self, timeout: Optional[float] = 10.0) -> Optional[np.ndarray]:
        """Next array, or None once the stream closed."""
        return self._q.get(timeout=timeout)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            arr = self.next()
            if arr is None:
                return
            yield arr

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()


class StreamingDataSetIterator(DataSetIterator):
    """Assemble DataSets from a features topic + labels topic (the Camel
    route's role: two streams zipped into training batches).  Bounded by
    ``max_batches`` per epoch so ``fit(..., epochs=1)`` terminates."""

    def __init__(self, address: Tuple[str, int],
                 features_topic: str = "features",
                 labels_topic: str = "labels",
                 max_batches: Optional[int] = None,
                 timeout: float = 10.0):
        self._features = NDArrayConsumer(address, features_topic).connect()
        self._labels = NDArrayConsumer(address, labels_topic).connect()
        self.max_batches = max_batches
        self.timeout = timeout
        self._count = 0
        self._pending_x: Optional[np.ndarray] = None

    def reset(self) -> None:
        self._count = 0

    def has_next(self) -> bool:
        return self.max_batches is None or self._count < self.max_batches

    def next(self) -> DataSet:
        # Iterator-protocol contract (datasets/iterators.py consumers like
        # AsyncDataSetIterator expect StopIteration, never queue.Empty).
        # A features frame whose labels frame hasn't arrived yet is stashed
        # so a later next() pairs it with ITS labels — a labels-side lag
        # must never skew the x/y pairing for the rest of the stream.
        try:
            x = self._pending_x if self._pending_x is not None \
                else self._features.next(timeout=self.timeout)
        except queue.Empty:
            raise StopIteration from None
        self._pending_x = x
        try:
            y = self._labels.next(timeout=self.timeout)
        except queue.Empty:
            raise StopIteration from None
        self._pending_x = None
        if x is None or y is None:
            raise StopIteration
        self._count += 1
        return DataSet(x, y)

    def __iter__(self):
        self.reset()
        while self.has_next():
            try:
                yield self.next()
            except StopIteration:
                return

    def close(self) -> None:
        self._features.close()
        self._labels.close()
