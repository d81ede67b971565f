"""Calibration batches from token ids.

The JAX package's ``looper/calibration.py`` for token-id input: a 2-D int
array or a list of 1-D sequences, optionally joined and cut into rows of
``concat_size``, sorted by length, and padded into fixed-shape batches with a
row mask (1 = real token). Strings need a tokenizer and multimodal rows need
the vision path; both raise here.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

log = logging.getLogger("gptqmodel_tpu_torch")

MIN_CALIBRATION_ROWS = 256
MIN_CALIBRATION_AVG_TOKENS = 256


@dataclass
class CalibrationBatches:
    input_ids: np.ndarray  # [n_batches, B, T] int32, 0-padded
    row_mask: np.ndarray  # [n_batches, B, T] float32, 1 = real token


def _to_token_rows(data) -> list[np.ndarray]:
    if isinstance(data, np.ndarray) and data.ndim == 2:
        return [np.asarray(r, dtype=np.int32) for r in data]
    rows = []
    for item in data:
        if isinstance(item, str):
            raise NotImplementedError(
                "string calibration data needs a tokenizer, which the port does not have "
                "yet; pass token ids")
        if isinstance(item, dict):
            raise NotImplementedError(
                "dict (multimodal) calibration rows wait for a later slice of the port; "
                "pass token ids")
        rows.append(np.asarray(item, dtype=np.int32).reshape(-1))
    return rows


def prepare_calibration(data, batch_size: int = 4, max_length: int = 2048,
                        concat_size: int | None = None, sort: str | None = "desc"
                        ) -> CalibrationBatches:
    """Token rows -> fixed-shape batches and masks. ``concat_size``: join all
    rows and cut them into rows of this length; ``sort``: "desc", "asc" or
    None, by length; rows longer than ``max_length`` are cut."""
    rows = _to_token_rows(data)
    if concat_size:
        flat = np.concatenate(rows)
        rows = [flat[i * concat_size:(i + 1) * concat_size]
                for i in range(len(flat) // concat_size)]
    if len(rows) < MIN_CALIBRATION_ROWS:
        log.warning("calibration has %d rows; reference recommends >= %d for stable "
                    "Hessians", len(rows), MIN_CALIBRATION_ROWS)
    avg = sum(len(r) for r in rows) / max(len(rows), 1)
    if avg < MIN_CALIBRATION_AVG_TOKENS:
        log.warning("calibration rows average %.0f tokens; reference recommends >= %d",
                    avg, MIN_CALIBRATION_AVG_TOKENS)
    if sort == "desc":
        rows = sorted(rows, key=len, reverse=True)
    elif sort == "asc":
        rows = sorted(rows, key=len)
    T = min(max(len(r) for r in rows), max_length)
    n_batches = (len(rows) + batch_size - 1) // batch_size
    ids = np.zeros((n_batches, batch_size, T), dtype=np.int32)
    mask = np.zeros((n_batches, batch_size, T), dtype=np.float32)
    for i, row in enumerate(rows):
        b, j = divmod(i, batch_size)
        n = min(len(row), T)
        ids[b, j, :n] = row[:n]
        mask[b, j, :n] = 1.0
    return CalibrationBatches(input_ids=ids, row_mask=mask)
