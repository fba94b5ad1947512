"""``ChessVision.process_image`` on one host photo: the web user's
request."""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np

from benchmark.harness import loop


class Entry(loop.Entry):
    def requests(self, start: int) -> Iterator[tuple[int, Callable[[], dict[str, Any]]]]:
        i = start
        while True:
            k = i % len(self.inputs)
            yield k, lambda k=k: self._one(self.inputs[k])
            i += 1

    def _one(self, photo: np.ndarray) -> dict[str, Any]:
        r = self.cv.process_image(photo, threshold=self.threshold)
        found = r.position is not None
        return {
            "logits": r.board_extraction.probabilities[None],
            "found": np.array([found]),
            "quadrangle": r.board_extraction.quadrangle[None] if found else None,
            "board_image": r.board_extraction.board_image[None] if found else None,
            "probabilities": r.position.model_probabilities[None] if found else None,
            "fens": [r.position.fen if found else ""],
        }
