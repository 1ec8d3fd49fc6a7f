"""Misc utilities (ref parity: utils/common.py:6-71).

A copy of `ref_geotransformer_tpu/utils/common.py`: only its imports differ (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict


def ensure_dir(path: str) -> None:
    if path and not os.path.exists(path):
        os.makedirs(path, exist_ok=True)


def load_pickle(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def dump_pickle(data, filename: str) -> None:
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def get_print_format(value) -> str:
    if isinstance(value, int):
        return "d"
    if isinstance(value, str):
        return "s"
    if value == 0:
        return ".3f"
    if abs(value) < 1e-6:
        return ".3e"
    if abs(value) < 1e-3:
        return ".6f"
    return ".3f"


def get_format_strings(kv_pairs) -> list:
    return [("{}: {:" + get_print_format(v) + "}").format(k, v) for k, v in kv_pairs]


def get_log_string(
    result_dict: Dict,
    epoch=None,
    max_epoch=None,
    iteration=None,
    max_iteration=None,
    lr=None,
    timer=None,
) -> str:
    log_strings = []
    if epoch is not None:
        epoch_string = f"Epoch: {epoch}"
        if max_epoch is not None:
            epoch_string += f"/{max_epoch}"
        log_strings.append(epoch_string)
    if iteration is not None:
        iter_string = f"iter: {iteration}"
        if max_iteration is not None:
            iter_string += f"/{max_iteration}"
        log_strings.append(iter_string)
    if "metadata" in result_dict:
        log_strings += result_dict["metadata"]
    log_strings += get_format_strings(
        [(k, v) for k, v in result_dict.items() if k != "metadata"]
    )
    if lr is not None:
        log_strings.append(f"lr: {lr:.3e}")
    if timer is not None:
        log_strings.append(timer.tostring())
    return ", ".join(log_strings)
