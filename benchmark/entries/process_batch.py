"""``Engine.process_batch`` on (B, H, W, 3) uint8 host frames, FENs
returned: what evaluation and ingestion call."""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np

from benchmark.harness import loop


class Entry(loop.Entry):
    def __init__(self, *a: Any) -> None:
        super().__init__(*a)
        self.boards_per_request = len(self.inputs[0])

    def requests(self, start: int) -> Iterator[tuple[int, Callable[[], dict[str, Any]]]]:
        engine = self.cv.engine
        i = start
        while True:
            k = i % len(self.inputs)
            yield k, lambda k=k: self._out(engine.process_batch(self.inputs[k], threshold=self.threshold))
            i += 1

    @staticmethod
    def _out(r: Any) -> dict[str, Any]:
        return {
            "logits": r.logits, "found": np.asarray(r.board_found, bool), "quadrangle": r.quadrangle,
            "board_image": r.board_image, "probabilities": r.probabilities, "fens": list(r.fens),
        }
