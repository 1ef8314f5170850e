"""Configuration layer: TOML loading and typed views.

A copy of ``columnflow/config.py`` (the port imports nothing of the JAX
package). ``load_config`` returns the plain dict of ``config/model.toml``;
``ColumnConfig`` is a typed, immutable view used by the model builders.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from typing import Any, Mapping

import numpy as np

# Population order within one column, everywhere in this framework
# (stimulus targets indices 2,3 = L4e/L4i).
POPULATION_NAMES = ("L2/3e", "L2/3i", "L4e", "L4i", "L5e", "L5i", "L6e", "L6i")
POPS_PER_COLUMN = 8

_DEFAULT_CONFIG_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config", "model.toml"
)


def load_config(filepath: str | None = None) -> dict:
    """Load configuration from a TOML file.

    With no argument, loads the repo's bundled ``config/model.toml``.
    """
    path = filepath or _DEFAULT_CONFIG_PATH
    with open(path, "rb") as f:
        return tomllib.load(f)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """Typed, immutable view of the biophysical configuration.

    All fields are host-side numpy/float data: weight construction happens in
    numpy at build time, and only the resulting tensors reach the device.
    """

    background_drive: float
    capacitance: float
    adaptation_strength: tuple[float, ...]
    tau_synapse: float
    tau_membrane: float
    tau_adaptation: float
    connection_probabilities: tuple[tuple[float, ...], ...]
    background_synapse_counts: tuple[float, ...]
    feedforward_synapse_counts: tuple[float, ...]
    baseline_synaptic_strength: float
    population_sizes: Mapping[str, tuple[float, ...]]
    connection_masks: Mapping[str, Any]
    connection_inits: Mapping[str, Any]

    @property
    def resistance(self) -> float:
        # R = tau_mem / C
        return self.tau_membrane / self.capacitance

    @staticmethod
    def from_dict(cfg: Mapping[str, Any]) -> "ColumnConfig":
        tc = cfg["time_constants"]
        return ColumnConfig(
            background_drive=float(cfg["background_drive"]),
            capacitance=float(cfg["capacitance"]),
            adaptation_strength=tuple(float(x) for x in cfg["adaptation_strength"]),
            tau_synapse=float(tc["synapse"]),
            tau_membrane=float(tc["membrane"]),
            tau_adaptation=float(tc["adaptation"]),
            connection_probabilities=tuple(
                tuple(float(x) for x in row)
                for row in cfg["connection_probabilities"]["internal"]
            ),
            background_synapse_counts=tuple(
                float(x) for x in cfg["synapse_counts"]["background"]
            ),
            feedforward_synapse_counts=tuple(
                float(x) for x in cfg["synapse_counts"]["feedforward"]
            ),
            baseline_synaptic_strength=float(cfg["synaptic_strength"]["baseline"]),
            population_sizes={
                k: tuple(float(x) for x in v) for k, v in cfg["population_size"].items()
            },
            connection_masks={
                k: _np(v) for k, v in cfg.get("connection_masks", {}).items()
            },
            connection_inits={
                k: _np(v) for k, v in cfg.get("connection_inits", {}).items()
            },
        )

    @staticmethod
    def load(filepath: str | None = None) -> "ColumnConfig":
        return ColumnConfig.from_dict(load_config(filepath))


def legacy_wta_config(cfg: ColumnConfig, scale: float = 1e-3) -> ColumnConfig:
    """The config generation that produced the original project's shipped
    "trained" WTA matrix: every baseline-derived weight scaled by ``scale``
    and the stale connection probability p[L2/3e <- L4e] = 0.0874 that
    ``config/model.toml`` records in a trailing comment."""
    probs = [list(r) for r in cfg.connection_probabilities]
    probs[0][2] = 0.0874
    return dataclasses.replace(
        cfg,
        baseline_synaptic_strength=cfg.baseline_synaptic_strength * scale,
        connection_probabilities=tuple(tuple(r) for r in probs),
    )
