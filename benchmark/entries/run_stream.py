"""``Engine.run_stream`` over host batches, of the mix's ``stream_kind``:
a request is one batch, complete when its FENs are on the host, assembled
from the batch's probabilities as the port's throughput example does
(validation, then FEN strings).  The stream stays open between requests,
so the upload of the next batch runs under the current one's compute."""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator

from benchmark.harness import loop


class Entry(loop.Entry):
    def __init__(self, *a: Any) -> None:
        super().__init__(*a)
        self.boards_per_request = len(self.inputs[0])
        self._stream: Any = None

    def requests(self, start: int) -> Iterator[tuple[int, Callable[[], dict[str, Any]]]]:
        from chessvision_tpu_torch import constants
        from chessvision_tpu_torch import engine as engine_mod

        n = len(self.inputs)
        self.close()
        feed = (self.inputs[i % n] for i in itertools.count(start))
        self._stream = self.cv.engine.run_stream(feed, threshold=self.threshold, kind=self.traffic["stream_kind"])
        names = constants.SQUARE_NAMES_NORMAL

        def one() -> dict[str, Any]:
            out = next(self._stream)
            host = engine_mod._copy_back(out, ("probabilities", "found"))
            validated, _ = engine_mod.validate_labels_batch(host["probabilities"], names)
            fens = engine_mod._fen_strings(host["probabilities"], validated, host["found"], names)[0]
            return {"device": out, "fens": fens, "found": host["found"], "probabilities": host["probabilities"]}

        i = start
        while True:
            yield i % n, one
            i += 1

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def to_host(self, out: dict[str, Any]) -> dict[str, Any]:
        dev = out["device"]
        return {
            "logits": dev["logits"].cpu().numpy(),
            "found": out["found"],
            "quadrangle": dev["quadrangle"].cpu().numpy(),
            "board_image": dev["board_image"].cpu().numpy(),
            "probabilities": out["probabilities"],
            "fens": out["fens"],
        }
