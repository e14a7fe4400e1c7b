"""internlm2-20b [dense]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
[arXiv:2403.17297; hf]

Counterpart of `repro/configs/internlm2_20b.py`.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchSpec, LM_SHAPES, lm_donate,
                                      lm_input_specs, lm_step,
                                      lm_tune_for_mesh)
from repro_torch.nn.transformer import TransformerConfig, TransformerLM

CONFIG = TransformerConfig(
    name="internlm2-20b",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=92544, rope_theta=1000000.0)

REDUCED = TransformerConfig(
    name="internlm2-reduced",
    n_layers=4, d_model=64, n_heads=8, n_kv=2, head_dim=8, d_ff=160,
    vocab=512, dtype="float32", loss_chunks=2)

SPEC = ArchSpec(
    name="internlm2-20b", family="lm",
    build=lambda device=None, seed=0, train=False: TransformerLM(
        CONFIG, device, seed, train),
    build_reduced=lambda device=None, seed=0, train=False: TransformerLM(
        REDUCED, device, seed, train),
    shapes=LM_SHAPES,
    input_specs=lm_input_specs,
    step=lm_step,
    tune_for_mesh=lm_tune_for_mesh,
    donate_inputs=lm_donate,
    notes="dense GQA kv=8.")
