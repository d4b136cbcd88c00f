"""Audio file discovery.

Counterpart of vocal_remover_tpu/data/pairing.py: for now only the list
of extensions that directory-mode separation picks up (the rest of
pairing comes with training). A file is picked when its lower-cased
extension is in the list.
"""

from __future__ import annotations

INPUT_EXTS = [".wav", ".m4a", ".mp3", ".mp4", ".flac", ".aac"]
