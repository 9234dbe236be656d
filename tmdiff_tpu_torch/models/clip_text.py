"""Frozen sensor-prompt text embeddings (port of the table part of
tmdiff_tpu/models/clip_text.py).

The reference conditions the UNet on pooled CLIP text embeddings (768,) of
five fixed per-sensor prompt paragraphs (`Hyper_unet_general.py:566-598`).
They are frozen constants, so they live in a (sensors, 768) table. The table
is read from `prompt_embeddings.npz` beside this file when one exists;
otherwise it is a deterministic placeholder: one unit-RMS Gaussian vector per
sensor, seeded by the sha256 of its prompt text, the same numbers the JAX
package draws.
"""
from __future__ import annotations

import functools
import hashlib
import os

import numpy as np

# Sensor prompt paragraphs, as the reference has them (its WV2 entry reuses
# the GaoFen-2 wording with WV2 numbers).
SENSOR_PROMPTS: dict[str, str] = {
    "QB": (
        "The QuickBird satellite captures high-resolution images with notable "
        "physical properties. Its panchromatic sensor acquires images at a "
        "0.61-meter resolution, providing crisp and detailed grayscale visuals. "
        "The multispectral sensor captures images at a 2.44-meter resolution in "
        "four spectral bands: blue (450-520 nm), green (520-600 nm), red "
        "(630-690 nm), and near-infrared (760-900 nm). These physical properties "
        "enable accurate Earth observation, supporting applications in "
        "environmental monitoring, land use planning, urban mapping, and "
        "disaster management."
    ),
    "WV3": (
        "The WorldView-3 satellite captures high-resolution images with "
        "exceptional physical properties. Its panchromatic sensor acquires "
        "images at a 31 cm resolution, delivering sharp and detailed grayscale "
        "visuals. The multispectral sensor captures images at a 1.24 m "
        "resolution in eight spectral bands: coastal (400-450 nm), blue "
        "(450-510 nm), green (510-580 nm), yellow (585-625 nm), red "
        "(630-690 nm), red edge (705-745 nm), near-infrared 1 (770-895 nm), and "
        "near-infrared 2 (860-1,040 nm). Additionally, WorldView-3 features a "
        "shortwave infrared (SWIR) sensor with 3.7 m resolution in eight bands "
        "(1,195-1,385 nm, 1,560-1,660 nm, 2,045-2,110 nm, etc.). These physical "
        "properties enable advanced Earth observation, supporting applications "
        "in environmental monitoring, land use planning, urban mapping, and "
        "disaster response."
    ),
    "GF2": (
        "The GaoFen-2 satellite captures high-resolution images with notable "
        "physical properties. Its panchromatic sensor acquires images at a "
        "1.0-meter resolution, delivering clear and detailed grayscale visuals. "
        "The multispectral sensor captures images at a 4.0-meter resolution in "
        "four spectral bands: blue (450-520 nm), green (520-590 nm), red "
        "(630-690 nm), and near-infrared (770-890 nm). These physical "
        "properties enable accurate Earth observation, supporting applications "
        "in urban planning, environmental monitoring, disaster management, and "
        "land use analysis."
    ),
    "WV2": (
        "The GaoFen-2 satellite captures high-resolution images with notable "
        "physical properties. Its panchromatic sensor acquires images at a "
        "0.5-meter resolution, delivering clear and detailed grayscale visuals. "
        "The multispectral sensor captures images at a 2.0-meter resolution in "
        "four spectral bands: blue (450-520 nm), green (520-590 nm), red "
        "(630-690 nm), and near-infrared (770-890 nm). These physical "
        "properties enable accurate Earth observation, supporting applications "
        "in urban planning, environmental monitoring, disaster management, and "
        "land use analysis."
    ),
    "WV4": (
        "The WorldView-4 satellite captures high-resolution images with "
        "remarkable physical properties. Its panchromatic sensor acquires "
        "images at a 31 cm resolution, providing sharp, detailed grayscale "
        "visuals. The multispectral sensor captures images at a 1.24 m "
        "resolution in four spectral bands: blue (450-510 nm), green "
        "(510-580 nm), red (630-690 nm), and near-infrared (770-895 nm). These "
        "physical properties enable precise Earth observation, facilitating "
        "applications in environmental monitoring, land use planning, and "
        "disaster response."
    ),
}

SENSORS: tuple[str, ...] = ("QB", "WV3", "GF2", "WV2", "WV4")
EMBED_DIM = 768

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "prompt_embeddings.npz")


def placeholder_text_embedding(text: str) -> np.ndarray:
    """Deterministic pseudo-CLIP vector for a prompt text: ~unit RMS per
    component, seeded by the sha256 of the text."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little")
    vec = np.random.default_rng(seed).standard_normal(EMBED_DIM)
    return (vec / np.linalg.norm(vec) * np.sqrt(EMBED_DIM)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def load_prompt_table() -> tuple[np.ndarray, dict[str, int], bool]:
    """Returns (table (S, 768), sensor -> row index, is_real_clip). Callers
    must not mutate the cached arrays."""
    index = {s: i for i, s in enumerate(SENSORS)}
    if os.path.exists(_TABLE_PATH):
        with np.load(_TABLE_PATH) as data:
            table = data["table"].astype(np.float32)
            is_real = bool(data["is_real_clip"]) if "is_real_clip" in data.files else False
        return table, index, is_real
    table = np.stack([placeholder_text_embedding(SENSOR_PROMPTS[s]) for s in SENSORS])
    return table, index, False
