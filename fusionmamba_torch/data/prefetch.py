"""The host side of the training input: items loaded by a thread pool, and
batches copied to the card ahead of the step that reads them. The port's
counterpart of `fusionmamba_tpu/data/prefetch.py`.

PIL releases the GIL while it decodes and resizes, so threads keep the host's
cores busy without worker processes. `device_prefetch` stacks each batch into
pinned host memory and copies it on a side stream, `depth` batches ahead, so
that the copy overlaps the running step (a `non_blocking` copy from pageable
numpy memory would be synchronous).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def threaded_batches(ds, batch_size: int, *, shuffle: bool = True, seed: int = 0,
                     drop_last: bool = True, num_workers: int = 8, prefetch: int = 4,
                     epochs: int | None = 1, rows: slice | None = None) -> Iterator[tuple]:
    """Stacked numpy batches of `ds`, its items loaded by `num_workers`
    threads, `prefetch` batches ahead: the same batches in the same order as
    `batch_iterator` with the same seed (and the same `rows`)."""
    rng = np.random.default_rng(seed)

    def epoch_orders():
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(ds))
            if shuffle:
                rng.shuffle(order)
            yield order
            epoch += 1

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for order in epoch_orders():
            windows = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
            if drop_last:
                windows = [w for w in windows if len(w) == batch_size]
            if rows is not None:
                windows = [w[rows] for w in windows]
            futs = [[pool.submit(ds.__getitem__, int(i)) for i in w] for w in windows[:prefetch]]
            for wi in range(len(windows)):
                if wi + prefetch < len(windows):
                    futs.append([pool.submit(ds.__getitem__, int(i))
                                 for i in windows[wi + prefetch]])
                items = [f.result() for f in futs.pop(0)]
                yield tuple(np.stack(parts) for parts in zip(*items))


def device_prefetch(iterator: Iterator[tuple], device: torch.device,
                    depth: int = 2) -> Iterator[tuple]:
    """The batches of `iterator` (tuples of numpy arrays) as tensors on
    `device`, made `depth` batches ahead by a producer thread. On a CUDA
    device each array is copied into pinned memory and sent with
    `non_blocking` on a side stream; the consumer's stream waits for that
    copy's event before it reads the tensors, and `record_stream` keeps the
    allocator from reusing their memory until the consumer's work is done.
    An exception in the producer is raised in the consumer."""
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def stage(batch):
        if not cuda:
            return tuple(torch.from_numpy(b) for b in batch), None
        with torch.cuda.stream(stream):
            out = tuple(torch.from_numpy(b).pin_memory().to(device, non_blocking=True)
                        for b in batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put(stage(batch)):
                    break
            else:
                put(done)
        except Exception as e:  # handed to the consumer
            put(e)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            tensors, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in tensors:
                    t.record_stream(current)
            yield tensors
    finally:
        stop.set()
        thread.join()
