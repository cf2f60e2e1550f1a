"""The batched inference server (DESIGN.md §16; port of
``repro.serving.server``).

Control plane (host threads): a request queue, fixed-shape batch assembly,
the checkpoint watcher's swap hook between batches, per-request latency
accounting. Data plane (device): one adapter call per batch at the fixed
``[max_batch, ...]`` shape — partial batches are padded with zero rows,
discarded on the host.

Two adapters:

* :class:`ClassifierAdapter` — a paper model (``models.paper_models``):
  request = one feature sample, response = its logits row.
* :class:`LMAdapter` — batched prefill + greedy decode (``launch/serve.py``)
  with the KV cache written in place: request = a fixed-length prompt,
  response = ``n_new`` generated tokens.

Weights live in :class:`~repro_torch.serving.hot_swap.WeightBuffers`. The
server never blocks a request on training: weights change only through
``watcher.maybe_swap()`` between batches.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.serve import (make_decode_step, make_prefill_step,
                                      next_token)
from repro_torch.models.transformer import check_supported
from repro_torch.serving.hot_swap import CheckpointWatcher, WeightBuffers
from repro_torch.serving.metrics import ServingMetrics


# ------------------------------------------------------------------ adapters
class ClassifierAdapter:
    """Batched logits for a ``models.paper_models.PaperModel``; ``params``
    is its ``{name: tensor}`` mapping (``model.params()``)."""

    request_dtype = np.float32

    def __init__(self, model, max_batch: int):
        self.model = model
        self.max_batch = int(max_batch)
        self.request_shape = tuple(model.input_shape)

    @torch.inference_mode()
    def infer(self, params, stack: torch.Tensor) -> np.ndarray:
        """stack: [max_batch, *input_shape] -> np [max_batch, n_classes]."""
        device = next(iter(params.values())).device
        out = self.model.apply(params, stack.to(device))
        return out.float().cpu().numpy()

    def tokens_per_request(self) -> int:
        return 0


class LMAdapter:
    """Batched greedy generation with the KV cache written in place.

    Requests are fixed-length int32 prompts (``prompt_len``); a batch runs
    one prefill plus ``n_new - 1`` decode steps (``launch/serve.py``) on the
    device that holds ``params`` (a ``models.transformer.TransformerLM``).
    """

    request_dtype = np.int32

    def __init__(self, cfg, max_batch: int, prompt_len: int, n_new: int,
                 cache_len: Optional[int] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.prompt_len = int(prompt_len)
        self.n_new = int(n_new)
        self.cache_len = int(cache_len or (prompt_len + n_new + 8))
        self.request_shape = (self.prompt_len,)
        self._prefill = make_prefill_step(cfg, self.cache_len)
        self._step = make_decode_step(cfg)

    def infer(self, params, stack: torch.Tensor) -> np.ndarray:
        """stack: int32 [max_batch, prompt_len] -> np int32 [max_batch, n_new]."""
        tokens = stack.to(device=params.embed.device, dtype=torch.int32)
        logits, state = self._prefill(params, tokens)
        tok = next_token(logits)
        out = [tok]
        for _ in range(self.n_new - 1):
            logits, state = self._step(params, tok, state)
            tok = next_token(logits)
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()

    def tokens_per_request(self) -> int:
        return self.n_new


# -------------------------------------------------------------------- server
class _Ticket:
    """One in-flight request: payload in, result/error out."""

    __slots__ = ("payload", "t_submit", "done", "result", "error")

    def __init__(self, payload: np.ndarray):
        self.payload = payload
        self.t_submit = time.perf_counter()
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError("request not served in time")
        if self.error is not None:
            raise self.error
        return self.result


class InferenceServer:
    """Queue -> fixed-shape batch -> adapter -> per-request responses.

    Drive it synchronously with :meth:`step` (tests, benchmarks) or as a
    background thread with :meth:`start`/:meth:`stop` (the load generator,
    the train+serve CLI). ``watcher`` is optional — without one the server
    serves its initial weights forever.
    """

    def __init__(self, adapter, params: Any = None, *, step: int = 0,
                 watcher: Optional[CheckpointWatcher] = None,
                 metrics: Optional[ServingMetrics] = None,
                 batch_wait_s: float = 0.002):
        self.adapter = adapter
        if watcher is not None:
            self.buffers = watcher.buffers   # weights live with the watcher
        elif params is not None:
            self.buffers = WeightBuffers(params, step=step)
        else:
            raise ValueError("need initial params or a watcher")
        self.watcher = watcher
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.batch_wait_s = batch_wait_s
        self._queue: "queue.Queue[_Ticket]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._zero = np.zeros(adapter.request_shape, adapter.request_dtype)

    # ------------------------------------------------------------ client side
    def submit(self, payload: np.ndarray) -> _Ticket:
        t = _Ticket(np.asarray(payload))
        self.metrics.record_submit()
        self._queue.put(t)
        return t

    # ------------------------------------------------------------ serve side
    def _collect(self, block: bool) -> list:
        """Up to ``max_batch`` queued tickets; with ``block`` waits
        ``batch_wait_s`` for the first one (micro-batching window)."""
        tickets = []
        try:
            tickets.append(self._queue.get(block=block,
                                           timeout=self.batch_wait_s))
        except queue.Empty:
            return tickets
        while len(tickets) < self.adapter.max_batch:
            try:
                tickets.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return tickets

    def step(self, block: bool = False) -> int:
        """Serve one batch: swap if a fresh buffer is staged, assemble, run,
        respond. Returns the number of requests served."""
        if self.watcher is not None:
            self.watcher.maybe_swap()
        tickets = self._collect(block)
        if not tickets:
            return 0
        pad = self.adapter.max_batch - len(tickets)
        rows = [t.payload for t in tickets] + [self._zero] * pad
        stack = torch.from_numpy(np.stack(rows))
        step_served = self.buffers.active_step
        self.metrics.record_batch(
            len(tickets), step_served,
            self.watcher.latest_seen if self.watcher is not None else None)
        try:
            out = self.adapter.infer(self.buffers.active_params, stack)
        except Exception as e:
            for t in tickets:
                t.error = e
                t.done.set()
                self.metrics.record_error()
            return len(tickets)
        now = time.perf_counter()
        toks = self.adapter.tokens_per_request()
        for i, t in enumerate(tickets):
            t.result = out[i]
            t.done.set()
            self.metrics.record_served((now - t.t_submit) * 1e6,
                                       step_served, tokens=toks)
        return len(tickets)

    def drain(self) -> int:
        """Serve until the queue is empty; returns requests served."""
        n = 0
        while True:
            served = self.step(block=False)
            if served == 0 and self._queue.empty():
                return n
            n += served

    # --------------------------------------------------------------- threading
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="inference-server", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.step(block=True)
        self.drain()   # never strand an accepted request on shutdown

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self.drain()
