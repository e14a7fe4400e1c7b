"""mistral-nemo-12b [dense]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072 — 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]

head_dim=128 (q-proj 5120 -> 4096), the published Nemo geometry.
Counterpart of `repro/configs/mistral_nemo_12b.py`.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchSpec, LM_SHAPES, lm_donate,
                                      lm_input_specs, lm_step,
                                      lm_tune_for_mesh)
from repro_torch.nn.transformer import TransformerConfig, TransformerLM

CONFIG = TransformerConfig(
    name="mistral-nemo-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1000000.0)

REDUCED = TransformerConfig(
    name="mistral-nemo-reduced",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16, d_ff=160,
    vocab=512, dtype="float32", loss_chunks=2)

SPEC = ArchSpec(
    name="mistral-nemo-12b", family="lm",
    build=lambda device=None, seed=0, train=False: TransformerLM(
        CONFIG, device, seed, train),
    build_reduced=lambda device=None, seed=0, train=False: TransformerLM(
        REDUCED, device, seed, train),
    shapes=LM_SHAPES,
    input_specs=lm_input_specs,
    step=lm_step,
    tune_for_mesh=lm_tune_for_mesh,
    donate_inputs=lm_donate,
    notes="128k-context dense GQA; head_dim 128 != d_model/n_heads.")
