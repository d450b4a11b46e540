"""One-frame-ahead dataset prefetching for the SLAM loop (a copy of the JAX
package's data/prefetch.py).

The reference loads each frame synchronously inside the per-frame loop
(SLAM.py:384: `self.dataset[idx]`: disk read, PNG/JPEG decode, resize).
This wraps any loader with a one-slot background thread: while frame i's
tracking and mapping run, frame i+1 is decoded. cv2's decode and resize
release the GIL, so the overlap is real. The thread only reads files and
returns numpy arrays; it does no device work.

Sequential access (the SLAM loop) hits the prefetched slot; random access
falls through to a direct load, so eval and video passes work unchanged.
"""
import concurrent.futures
import threading


class Prefetcher:
    def __init__(self, dataset, enabled: bool = True):
        self.dataset = dataset
        self.enabled = enabled
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="frame-prefetch") if enabled else None)
        self._lock = threading.Lock()
        self._next_idx = None
        self._future = None

    def __len__(self):
        return len(self.dataset)

    def _schedule(self, idx: int):
        if 0 <= idx < len(self.dataset):
            self._next_idx = idx
            self._future = self._pool.submit(self.dataset.__getitem__, idx)
        else:
            self._next_idx = None
            self._future = None

    def __getitem__(self, idx: int):
        if not self.enabled:
            return self.dataset[idx]
        with self._lock:
            # re-check enabled inside the lock: a close() that won the race
            # flipped it and shut the pool down, and a later submit would
            # raise "cannot schedule new futures after shutdown"
            if not self.enabled:
                return self.dataset[idx]
            if self._next_idx == idx and self._future is not None:
                item = self._future.result()
            else:
                item = self.dataset[idx]
            self._schedule(idx + 1)
            return item

    def close(self):
        """Stop the worker; later accesses degrade to direct loads."""
        if self._pool is not None:
            with self._lock:
                self.enabled = False
                self._next_idx = None
                self._future = None
            self._pool.shutdown(wait=False, cancel_futures=True)
