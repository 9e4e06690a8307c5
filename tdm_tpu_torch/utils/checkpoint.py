"""Checkpoint and resume of the whole training state.

Port of `tdm_tpu/utils/checkpoint.py` without orbax: `checkpoint-{step}/`
directories under the output directory (the reference's naming,
`src/main.py:563-587`), rotated by `total_limit`, each holding one
safetensors file per tensor tree (written by the port's numpy writer,
`io/params.py`) and `state.json` with the step and the optimizers' counters:

    checkpoint-{step}/
      state.json             {"step", "ema", "student_count", "critic_count", ...}
      student.safetensors    fp32 master weights (port state_dict names), or
                             a LoRA student's factors ('{module path}/a', '/b')
      critic.safetensors
      ema.safetensors        when the EMA is kept
      student_opt.safetensors  every tensor of the optimizer state, named by
      critic_opt.safetensors   its field path: 'mu/{name}' and 'nu/{name}'
                               (AdamW; bf16 moments widened to fp32), the
                               int8 'mu/codes' with fp32 'mu/scales' and
                               'mu/small' (8-bit Adam), 'acc/{name}' and
                               'inner/...' (accumulation)

Each integer of an optimizer state is a counter in state.json under its
role and field path: `student_count` for AdamW and 8-bit Adam;
`student_mini_step`, `student_gradient_step` and `student_inner_count`
under accumulation. A directory is written under a temporary name and
renamed when complete. The format is the port's own; orbax cannot read it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from tdm_tpu_torch.io import params as params_io

_DIR = re.compile(r"checkpoint[-_](\d+)")


def _trees(state) -> dict[str, Optional[dict]]:
    return {"student": state.student, "critic": state.critic, "ema": state.ema}


def _walk(node, prefix: str, tensors: dict, counters: dict) -> None:
    """Every tensor and integer of an optimizer state (named tuples, dicts
    of tensors, tensors, ints), keyed by its '/'-joined field path."""
    if isinstance(node, torch.Tensor):
        tensors[prefix] = node
    elif isinstance(node, int):
        counters[prefix] = node
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            _walk(getattr(node, f), f"{prefix}/{f}" if prefix else f, tensors, counters)
    elif isinstance(node, dict):
        for k, v in node.items():
            _walk(v, f"{prefix}/{k}" if prefix else k, tensors, counters)
    elif node is not None:
        raise TypeError(f"optimizer state field {prefix!r}: {type(node).__name__}")


def _with_counters(node, prefix: str, counters: dict):
    """`node` with each integer replaced by counters[its field path]."""
    if isinstance(node, int):
        return counters[prefix]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(
            _with_counters(getattr(node, f), f"{prefix}/{f}" if prefix else f, counters)
            for f in node._fields))
    return node


def _opt_parts(opt_state) -> tuple[dict, dict]:
    tensors, counters = {}, {}
    _walk(opt_state, "", tensors, counters)
    return tensors, counters


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()  # exact; numpy has no bfloat16
    return t.cpu().numpy()


def _load_into(path: str, tree: dict) -> None:
    """Copy every tensor of a safetensors file into `tree`'s tensors, in
    place; the key sets must be equal."""
    flat = params_io.load_file(path)
    if set(flat) != set(tree):
        raise KeyError(f"{path}: keys differ from the run's")
    for k, t in tree.items():
        t.copy_(torch.from_numpy(flat[k]))


class CheckpointManager:
    """checkpoint-{step} directories under `output_dir`, the newest
    `total_limit` kept (all when None)."""

    def __init__(self, output_dir: str, *, total_limit: Optional[int] = None):
        self.output_dir = os.path.abspath(output_dir)
        self.total_limit = total_limit
        os.makedirs(self.output_dir, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for d in os.listdir(self.output_dir)
            if (m := _DIR.fullmatch(d)) and os.path.isdir(os.path.join(self.output_dir, d))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.output_dir, f"checkpoint-{step}")

    def save(self, step: int, state) -> str:
        final = self.path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        trees = _trees(state)
        meta = {"step": int(step), "ema": state.ema is not None}
        for role in ("student", "critic"):
            tensors, counters = _opt_parts(getattr(state, f"{role}_opt"))
            trees[f"{role}_opt"] = tensors
            meta.update({f"{role}_{k.replace('/', '_')}": int(v) for k, v in counters.items()})
        for name, tree in trees.items():
            if tree is not None:
                params_io.save_file(
                    {k: _to_numpy(v) for k, v in tree.items()},
                    os.path.join(tmp, f"{name}.safetensors"),
                )
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.total_limit is not None:
            for old in self.steps()[: -self.total_limit or None]:
                shutil.rmtree(self.path(old), ignore_errors=True)
        return final

    def restore(self, state, step: Optional[int] = None):
        """`state` with every tensor overwritten in place from the
        checkpoint of `step` (the latest when None), its step and
        optimizer counters taken from it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.output_dir}")
        path = self.path(step)
        with open(os.path.join(path, "state.json")) as f:
            meta = json.load(f)
        if meta["ema"] != (state.ema is not None):
            raise ValueError(
                f"{path}: saved {'with' if meta['ema'] else 'without'} an EMA, "
                f"the run is {'with' if state.ema is not None else 'without'} one"
            )
        opts = {}
        with torch.no_grad():
            for name, tree in _trees(state).items():
                if tree is not None:
                    _load_into(os.path.join(path, f"{name}.safetensors"), tree)
            for role in ("student", "critic"):
                opt = getattr(state, f"{role}_opt")
                tensors, counters = _opt_parts(opt)
                _load_into(os.path.join(path, f"{role}_opt.safetensors"), tensors)
                try:
                    saved = {k: meta[f"{role}_{k.replace('/', '_')}"] for k in counters}
                except KeyError as e:
                    raise KeyError(f"{path}: no counter {e} for the run's optimizer") from None
                opts[f"{role}_opt"] = _with_counters(opt, "", saved)
        return state._replace(step=meta["step"], **opts)


def resolve_resume_step(output_dir: str, resume: str) -> Optional[int]:
    """The `--resume_from_checkpoint` convention (`src/main.py:379-401`):
    'latest' scans the checkpoint-* directories; anything else names one.
    None when there is nothing to resume."""
    if resume != "latest":
        m = re.search(r"checkpoint[-_](\d+)", resume)
        if not m:
            raise ValueError(f"cannot parse step from {resume!r}")
        return int(m.group(1))
    if not os.path.isdir(output_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(output_dir) if (m := _DIR.fullmatch(d))]
    return max(steps) if steps else None
