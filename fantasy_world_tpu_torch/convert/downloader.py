"""Local resolution of model files (the local part of
``convert/downloader.py``).

Resolution is glob-first, and files already on disk are used as they are.
The port never calls a hub: where the JAX package would download, it
raises ``FileNotFoundError`` naming the preset (or model id) and the
directory to place the files in.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Union

T5_PROBE = "models_t5_umt5-xxl-enc-bf16.pth"


def _holds_checkpoint(d: str, extra=()) -> bool:
    return os.path.isdir(d) and (
        os.path.exists(os.path.join(d, T5_PROBE))
        or any(glob.glob(os.path.join(d, pat))
               for pat in ("*.safetensors", *extra)))


@dataclasses.dataclass
class ModelConfig:
    """A model source: a concrete ``path``, or {model_id,
    origin_file_pattern} globbed under ``local_model_path``/<model_id>/."""
    path: Union[str, List[str], None] = None
    model_id: Optional[str] = None
    origin_file_pattern: Union[str, List[str], None] = None
    local_model_path: Optional[str] = None

    def download_if_necessary(self) -> None:
        """Set ``path`` from the files on disk; nothing is fetched."""
        if self.path is not None:
            return
        if self.model_id is None:
            raise ValueError(
                'No valid model files. Use ModelConfig(path="xxx") or '
                'ModelConfig(model_id="xxx/yyy", origin_file_pattern="zzz").')
        base = os.path.join(self.local_model_path or "./models",
                            self.model_id)
        pattern = self.origin_file_pattern or ""
        is_folder = pattern == "" or pattern.endswith("/")
        matches = glob.glob(os.path.join(base, pattern or "*"))
        if not matches:
            raise FileNotFoundError(
                f"no files matching {pattern!r} under {base} for "
                f"{self.model_id} (nothing is downloaded: place them there)")
        if is_folder:
            self.path = os.path.join(base, pattern)
        else:
            self.path = sorted(matches)
            if len(self.path) == 1:
                self.path = self.path[0]


def resolve_ckpt_dir(ckpt_dir: str,
                     preset: str = "Wan2.1-I2V-14B-480P") -> str:
    """``ckpt_dir`` when it holds a checkpoint layout or a bundle (the umT5
    file or ``*.safetensors``), else ``<parent>/<preset>`` when that does;
    otherwise ``FileNotFoundError`` naming the preset and the directory
    (where the JAX package would fetch the preset)."""
    if _holds_checkpoint(ckpt_dir):
        return ckpt_dir
    root = os.path.dirname(ckpt_dir.rstrip("/")) or "."
    cand = os.path.join(root, preset)
    if cand != ckpt_dir and _holds_checkpoint(cand, ("*.pth", "*.pt")):
        return cand
    raise FileNotFoundError(
        f"no {preset} checkpoint in {ckpt_dir} (nothing is downloaded: "
        f"place the preset's files there or in {cand})")
