"""The program's entry points that a traffic mix can name (its "entry"),
each driven as a user would call it.  An entry turns one request's Annex B
bytes into the request's pictures: cropped (y, cb, cr) tensors on the
card, in display order (the mixes' "output" is "device"; host output
would need its own entry call).

The program is imported only inside these functions, after the harness
has looked for a card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


@dataclass
class Entry:
    call: Callable      # (stream bytes, timers or None) -> [(y, cb, cr)]
    steps: object       # the path's graphs.StepCache
    fallbacks: Callable  # () -> requests that left the path so far


def _crop(cfg):
    h, w = cfg["height"], cfg["width"]
    return lambda y, cb, cr: (y[:h, :w], cb[:h // 2, :w // 2],
                              cr[:h // 2, :w // 2])


def _on_card(traffic):
    if traffic["output"] != "device":
        raise ValueError(f"output {traffic['output']!r}: the entries hand "
                         f"back planes on the card only")


def ipb_packed(traffic, cfg, device) -> Entry:
    """device_ipb_packed.decode_annexb_device_packed: one picture a graph
    replay, the host's entropy, motion and pack ahead of it."""
    from dryv_tpu_torch import device_ipb_packed as m

    _on_card(traffic)
    crop = _crop(cfg)

    def call(stream, timers):
        frames = m.decode_annexb_device_packed(
            stream, n_threads=traffic["n_threads"], device_out=True,
            device=device, timers=timers, graph=True)
        return [crop(y, cb, cr) for y, cb, cr, _poc, _sps in frames]

    return Entry(call, m.STEPS,
                 lambda: m.decode_annexb_device_packed.host_calls)


def intra_batched(traffic, cfg, device) -> Entry:
    """gop_pipeline.decode_annexb_gop_pipelined: batches of `batch` IDR
    pictures, the host's entropy of batch k+1 beside the card's step of
    batch k."""
    from dryv_tpu_torch import gop_pipeline as m

    _on_card(traffic)
    crop = _crop(cfg)

    def call(stream, timers):
        out = m.decode_annexb_gop_pipelined(
            stream, gop=traffic["batch"], n_threads=traffic["n_threads"],
            device=device, stacked_out=True, timers=timers, graph=True)
        return [crop(y[i], cb[i], cr[i]) for y, cb, cr, nf in out
                for i in range(nf)]

    return Entry(call, m.STEPS,
                 lambda: m.decode_annexb_gop_pipelined.fallback_calls)


ENTRIES = {"ipb_packed": ipb_packed, "intra_batched": intra_batched}
