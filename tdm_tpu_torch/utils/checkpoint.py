"""Checkpoint and resume of the whole training state.

Port of `tdm_tpu/utils/checkpoint.py` without orbax: `checkpoint-{step}/`
directories under the output directory (the reference's naming,
`src/main.py:563-587`), rotated by `total_limit`, each holding one
safetensors file per tensor tree (written by the port's numpy writer,
`io/params.py`) and `state.json` with the step and the optimizer counts:

    checkpoint-{step}/
      state.json                  {"step", "student_count", "critic_count", "ema"}
      student.safetensors         fp32 master weights, port state_dict names
      critic.safetensors
      ema.safetensors             when the EMA is kept
      student_mu.safetensors      Adam moments (bf16 moments widened to fp32)
      student_nu.safetensors
      critic_mu.safetensors
      critic_nu.safetensors

A directory is written under a temporary name and renamed when complete. The
format is the port's own; orbax cannot read it.
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
    return {
        "student": state.student, "critic": state.critic, "ema": state.ema,
        "student_mu": state.student_opt.mu, "student_nu": state.student_opt.nu,
        "critic_mu": state.critic_opt.mu, "critic_nu": state.critic_opt.nu,
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()  # exact; numpy has no bfloat16
    return t.cpu().numpy()


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
        for name, tree in _trees(state).items():
            if tree is not None:
                params_io.save_file(
                    {k: _to_numpy(v) for k, v in tree.items()},
                    os.path.join(tmp, f"{name}.safetensors"),
                )
        with open(os.path.join(tmp, "state.json"), "w") as f:
            json.dump({
                "step": int(step),
                "student_count": int(state.student_opt.count),
                "critic_count": int(state.critic_opt.count),
                "ema": state.ema is not None,
            }, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.total_limit is not None:
            for old in self.steps()[: -self.total_limit or None]:
                shutil.rmtree(self.path(old), ignore_errors=True)
        return final

    def restore(self, state, step: Optional[int] = None):
        """`state` with every tensor overwritten in place from the
        checkpoint of `step` (the latest when None), its step and counts
        taken from it."""
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
        with torch.no_grad():
            for name, tree in _trees(state).items():
                if tree is None:
                    continue
                flat = params_io.load_file(os.path.join(path, f"{name}.safetensors"))
                if set(flat) != set(tree):
                    raise KeyError(f"{path}/{name}: keys differ from the run's")
                for k, t in tree.items():
                    t.copy_(torch.from_numpy(flat[k]))
        return state._replace(
            step=meta["step"],
            student_opt=state.student_opt._replace(count=meta["student_count"]),
            critic_opt=state.critic_opt._replace(count=meta["critic_count"]),
        )


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
