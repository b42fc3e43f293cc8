# Copy of dryv_tpu/utils/ckpt.py.
"""Checkpoint / resume for long-GOP decoding.

The DPB is the only long-lived cross-frame state (SURVEY.md §5); it is a
plain value, so snapshotting (frame index, POC state, reference picture
metadata) lets a multi-host job restart any frame shard from its NAL bytes
(pure functions make every picture re-decodable)."""
from __future__ import annotations

import dataclasses
import json

from ..avc.dpb import DecodedPictureBuffer, Picture


def snapshot_dpb(dpb: DecodedPictureBuffer) -> str:
    state = {
        "pictures": [dataclasses.asdict(p) for p in dpb.pictures],
        "prev_pic_order_cnt_msb": dpb.prev_pic_order_cnt_msb,
        "prev_pic_order_cnt_lsb": dpb.prev_pic_order_cnt_lsb,
        "prev_frame_num": dpb.prev_frame_num,
        "prev_frame_num_offset": dpb.prev_frame_num_offset,
        "max_long_term_frame_idx": dpb.max_long_term_frame_idx,
        "decode_count": dpb._decode_count,
        # PAFF: POC of the most recent decoded fields (MBAFF/field direct
        # prediction reads these via decoder.py)
        "last_top": getattr(dpb, "_last_top", 0),
        "last_bottom": getattr(dpb, "_last_bottom", 0),
    }
    return json.dumps(state)


def restore_dpb(blob: str) -> DecodedPictureBuffer:
    state = json.loads(blob)
    dpb = DecodedPictureBuffer()
    dpb.pictures = [
        Picture(**{**p, "field_ref": tuple(p["field_ref"])})
        for p in state["pictures"]]
    dpb.prev_pic_order_cnt_msb = state["prev_pic_order_cnt_msb"]
    dpb.prev_pic_order_cnt_lsb = state["prev_pic_order_cnt_lsb"]
    dpb.prev_frame_num = state["prev_frame_num"]
    dpb.prev_frame_num_offset = state["prev_frame_num_offset"]
    dpb.max_long_term_frame_idx = state["max_long_term_frame_idx"]
    dpb._decode_count = state["decode_count"]
    dpb._last_top = state.get("last_top", 0)
    dpb._last_bottom = state.get("last_bottom", 0)
    return dpb
