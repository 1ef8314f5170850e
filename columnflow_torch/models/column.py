"""Cortical-column area construction: anatomy -> weight matrices.

A copy of ``columnflow/models/column.py`` (pure numpy, init-time only), plus
``area_to_torch``, which moves an area's arrays onto a device for the drift.

Weight-construction math:
    synapse counts   K[i,j] = ln(1 - p[i,j]) / ln(1 - 1/(N_i N_j)) / N_i
    strength         S[i,j] = baseline * (-N_e/N_i if j inhibitory else 1),
                     within-column only (internal mask)
    recurrent        W = K * S
    background       w_bg = counts_bg * baseline        (per population)
    feedforward      w_ff = counts_ff * baseline        (per population)

``small_network=True`` divides population sizes by the number of columns and
uses the hardcoded background count 2510 — the WTA/XOR regime.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from columnflow_torch.config import POPS_PER_COLUMN, ColumnConfig


class Stimulus(NamedTuple):
    """A stimulus table on a uniform time grid (t0 + dt * arange(T))."""

    t0: float
    dt: float
    table: torch.Tensor  # (T, ...) values; interpolated at solver time


class AreaParams(NamedTuple):
    """Weights and constants of one column area.

    ``build_area_params`` fills the arrays with numpy; ``area_to_torch``
    gives the same area with float32 tensors and Python-float scalars."""

    recurrent_weights: np.ndarray  # (P, P)
    background_current: np.ndarray  # (P,) = w_bg * background_drive
    feedforward_weights: np.ndarray  # (P,)
    adaptation_strength: np.ndarray  # (P,)
    internal_mask: np.ndarray  # (P, P) ones within columns
    external_mask: np.ndarray  # (P, P) ones across columns
    population_sizes: np.ndarray  # (P,)
    tau_syn: float
    tau_mem: float
    tau_adapt: float
    resistance: float
    background_drive: float


_SCALAR_FIELDS = ("tau_syn", "tau_mem", "tau_adapt", "resistance",
                  "background_drive")


def _recurrent_synapse_counts(conn_prob: np.ndarray, pop_sizes: np.ndarray):
    log_num = np.log(1.0 - conn_prob)
    log_den = np.log(1.0 - 1.0 / np.outer(pop_sizes, pop_sizes))
    return log_num / log_den / pop_sizes[:, None]


def _strength_matrix(cfg: ColumnConfig, pop_sizes: np.ndarray, internal_mask):
    base = cfg.baseline_synaptic_strength
    inhib_scale = -pop_sizes[0::2] / pop_sizes[1::2]
    col = np.full(pop_sizes.shape[0], base)
    col[1::2] = inhib_scale * base
    return np.tile(col, (pop_sizes.shape[0], 1)) * internal_mask


def _masks(num_pops: int, num_columns: int):
    mask = np.zeros((num_pops, num_pops))
    csize = num_pops // num_columns
    for i in range(0, num_pops, csize):
        mask[i : i + csize, i : i + csize] = 1.0
    return mask, 1.0 - mask


def build_area_params(
    cfg: ColumnConfig,
    area: str,
    num_columns: int,
    small_network: bool = False,
    dtype=np.float32,
) -> AreaParams:
    """Build all weights for an area of ``num_columns`` columns (numpy)."""
    pop_sizes = np.tile(np.asarray(cfg.population_sizes[area.lower()]), num_columns)
    if small_network:
        pop_sizes = pop_sizes / num_columns
    num_pops = pop_sizes.shape[0]

    internal_mask, external_mask = _masks(num_pops, num_columns)

    conn_prob = np.kron(np.eye(num_columns), np.asarray(cfg.connection_probabilities))
    synapse_counts = _recurrent_synapse_counts(conn_prob, pop_sizes)
    strength = _strength_matrix(cfg, pop_sizes, internal_mask)
    recurrent = synapse_counts * strength

    if small_network:
        bg_counts = np.full(POPS_PER_COLUMN, 2510.0)
    else:
        bg_counts = np.asarray(cfg.background_synapse_counts)
    bg_counts = np.tile(bg_counts, num_columns)
    ff_counts = np.tile(np.asarray(cfg.feedforward_synapse_counts), num_columns)

    base = cfg.baseline_synaptic_strength
    return AreaParams(
        recurrent_weights=recurrent.astype(dtype),
        background_current=(bg_counts * base * cfg.background_drive).astype(dtype),
        feedforward_weights=(ff_counts * base).astype(dtype),
        adaptation_strength=np.tile(
            np.asarray(cfg.adaptation_strength), num_columns
        ).astype(dtype),
        internal_mask=internal_mask.astype(dtype),
        external_mask=external_mask.astype(dtype),
        population_sizes=pop_sizes.astype(dtype),
        tau_syn=dtype(cfg.tau_synapse),
        tau_mem=dtype(cfg.tau_membrane),
        tau_adapt=dtype(cfg.tau_adaptation),
        resistance=dtype(cfg.resistance),
        background_drive=dtype(cfg.background_drive),
    )


def area_to_torch(area: AreaParams, device=None) -> AreaParams:
    """The same area with float32 tensors on ``device`` and its scalars as
    Python floats (each one the float32 value exactly, so tensor arithmetic
    with it rounds as the JAX package's float32 scalars do)."""
    fields = {}
    for name in AreaParams._fields:
        val = getattr(area, name)
        if name in _SCALAR_FIELDS:
            fields[name] = float(np.float32(val))
        else:
            fields[name] = torch.as_tensor(np.array(val, dtype=np.float32),
                                           device=device)
    return AreaParams(**fields)
