"""Reduced-scale fusion configs (``utils/demo.py``) for the trainer's
``--synthetic`` mode and the tests: every component keeps its production
structure (PCB prefix + IRG stack, camera adapters, DPT layer taps) at
scaled widths. The full-size config is ``FusionConfig()``."""
from __future__ import annotations

from ..models.fusion.bicross import BicrossConfig
from ..models.fusion.model import FusionConfig
from ..models.vggt.aggregator import AggregatorConfig
from ..models.vggt.model import VGGTConfig
from ..models.wan.dit import WanDiTConfig


def demo_config(dim: int = 768, layers: int = 8, start_index: int = 4,
                agg_dim: int = 256, text_dim: int = 4096,
                plucker_dim: int = 2048,
                clip_feature_dim: int = 1280) -> FusionConfig:
    """The JAX package's ``demo_config``: the aggregator depth follows the
    IRG count (layers - start_index); the conditioning widths default to
    the production ones."""
    heads = max(1, dim // 128)
    n_irg = layers - start_index
    dpt_idx = tuple(sorted({n_irg - 1, max(0, n_irg * 3 // 4),
                            max(0, n_irg // 2), max(0, n_irg // 4)},
                           reverse=True))
    while len(dpt_idx) < 4:
        dpt_idx = dpt_idx + (0,)
    return FusionConfig(
        dit=WanDiTConfig(dim=dim, in_dim=36,
                         ffn_dim=-(-dim * 27 // 10 // 128) * 128,
                         out_dim=16, text_dim=text_dim, num_heads=heads,
                         num_layers=layers, has_image_input=True,
                         camera_adapter_end=min(25, start_index + 2),
                         plucker_dim=plucker_dim,
                         clip_feature_dim=clip_feature_dim),
        vggt=VGGTConfig(embed_dim=agg_dim, wan_dim=dim,
                        dpt_layer_idx=dpt_idx[:4],
                        aggregator=AggregatorConfig(
                            embed_dim=agg_dim, depth=n_irg,
                            num_heads=max(4, agg_dim // 64))),
        bicross=BicrossConfig(m1_dim=dim, m2_dim=agg_dim, hidden=96,
                              num_heads=4),
        start_index=start_index)
