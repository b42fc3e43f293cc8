# Copy of dryv_tpu/container/__init__.py.
"""MP4/QuickTime container layer.

Demux (atoms.py): the reference's atom tree (src/video/atom/, §2.3 of
SURVEY.md) — ftyp/mdat/moov, trak/mdia/minf/stbl, sample tables, stsd codec
entries with avcC, udta/meta tags — with lazy decode and streamed sample
tables.  Mux (mux.py): fixture MP4 writer (the reference has no muxer; ours
exists because fixtures must be self-generated).
"""
from .atoms import MP4File, Atom, AtomError, DecoderBrand
from .mux import write_mp4

__all__ = ["MP4File", "Atom", "AtomError", "DecoderBrand", "write_mp4"]
