"""Fixture: blocking-in-hot-loop NEGATIVE — timed waits and an event
fetch in the loop, blocking calls outside hot methods."""

import time

import torch

from sparkdl_torch.runtime.completion import start_fetch


class Batcher:
    def _loop(self):
        while not self._stop.wait(0.01):  # timed: fine
            out = self._pending.result(timeout=5.0)
            self._consume(out)

    def shutdown(self):
        # not a hot method: unbounded join is the caller's choice
        self._worker.join()
        time.sleep(0.05)


class Engine:
    def tick(self):
        handle = start_fetch(self._toks, path="decode")
        return handle.result(timeout=30.0)

    def close(self):
        # not a hot method: the teardown may drain the card
        torch.cuda.synchronize()
        return self._toks.sum().item()
