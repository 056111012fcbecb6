"""Fixture: blocking-in-hot-loop POSITIVE — sleeps, unbounded waits and
host-device syncs inside the loop, including through a same-class
helper."""

import time

import torch


class Batcher:
    def _loop(self):
        while not self._stop.is_set():
            time.sleep(0.01)  # VIOLATION: sleeping engine thread
            self._resolve()

    def _resolve(self):
        out = self._pending.result()  # VIOLATION: un-timed-out wait
        self._worker.join()  # VIOLATION: un-timed-out join
        return out


class Engine:
    def tick(self):
        torch.cuda.synchronize()  # VIOLATION: drains the whole card
        self._decode()

    def _decode(self):
        self._done.synchronize()  # VIOLATION: an event's host wait
        torch.cuda.current_stream().synchronize()  # VIOLATION: a stream's
        return self._toks[0].item()  # VIOLATION: sync D2H read
