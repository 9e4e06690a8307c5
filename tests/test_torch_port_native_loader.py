"""The port's native C++ prompt loader (`tdm_tpu_torch/csrc/dataloader.cc`
through `data/native_loader.py`) against the JAX package's on the CPU: the
same shard and seed give the same batches, prompt for prompt and token for
token; the library is built from the port's own source into the
repository's build directory; the training CLI reads a .txt shard through
it, and without g++ keeps the Python batcher with a warning."""

import json
import logging

import numpy as np
import pytest
import torch

from tdm_tpu.data import native_loader as jloader, tokenizer as jtok
from tdm_tpu_torch.data import native_loader as tloader, tokenizer as ttok
from tdm_tpu_torch.ops import _build

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    txt = d / "prompts.txt"
    txt.write_text("".join(f"prompt number {i} of the shard\n" for i in range(37)))
    rows = [{"caption": f"caption {i}", "meta": i} for i in range(20)]
    rows[3]["caption"] = 'escaped "quote" \\n and a tab\\t'
    jsonl = d / "prompts.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(txt), str(jsonl)


@pytest.mark.parametrize("shard,kw", [
    (0, {"seed": 3}),
    (0, {"seed": 11, "host_index": 1, "host_count": 2}),
    (1, {"seed": 5, "caption_column": "caption"}),
])
def test_batches_match_jax(shards, shard, kw):
    """Ten batches of 4 (past the epoch boundaries, where both reshuffle),
    the prompts and the hash tokenizer's ids and masks equal."""
    path = shards[shard]
    t = tloader.NativePromptLoader(path, 4, tokenizer=ttok.HashTokenizer(), max_length=12, **kw)
    j = jloader.NativePromptLoader(path, 4, tokenizer=jtok.HashTokenizer(), max_length=12, **kw)
    try:
        assert t.num_prompts == j.num_prompts
        for _ in range(10):
            a, b = next(t), next(j)
            assert a["prompts"] == b["prompts"]
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            np.testing.assert_array_equal(a["attention_mask"], b["attention_mask"])
    finally:
        t.close()
        j.close()


def test_built_from_the_ports_own_source_into_the_build_dir(shards):
    """The library is the port's copy of the loader, built into
    build/tdm_tpu_torch/ beside the kernels and keyed by the source's hash;
    a shard smaller than a batch is refused as in JAX."""
    assert tloader.unavailable_reason() is None
    assert tloader.SOURCE.parent == _build.CSRC and tloader.SOURCE.exists()
    path = tloader.library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert "dataloader" not in _build.kernel_names()  # a host library, not a kernel
    with pytest.raises(ValueError, match="smaller than batch_size"):
        tloader.NativePromptLoader(shards[0], 64)


def _cli(tmp_path, *extra):
    from tdm_tpu_torch.cli import train_tdm

    train_tdm.main(["--device", "cpu", "--output_dir", str(tmp_path / "run"), "--seed", "0",
                    "--train_batch_size", "2", "--max_train_steps", "2",
                    "--export_lora_rank", "0", *extra])


def test_cli_reads_a_txt_shard_through_the_native_loader(tmp_path, monkeypatch, shards, caplog):
    """--train_data_dir <.txt>: each micro-step's batch comes from the
    native loader (two batches for two steps), which the run closes at its
    end; without g++ the CLI warns with the reason and reads the shard with
    the Python batcher."""
    monkeypatch.setenv("TDM_TINY_MODEL", "1")
    monkeypatch.delenv("TDM_EMBEDDING_CACHE", raising=False)
    monkeypatch.delenv("TDM_TAESD_DIR", raising=False)
    served, closed = [], []
    nxt, close = tloader.NativePromptLoader.__next__, tloader.NativePromptLoader.close
    monkeypatch.setattr(tloader.NativePromptLoader, "__next__",
                        lambda self: served.append(1) or nxt(self))
    monkeypatch.setattr(tloader.NativePromptLoader, "close",
                        lambda self: closed.append(1) or close(self))
    with caplog.at_level(logging.INFO, logger="tdm_tpu_torch"):
        _cli(tmp_path, "--train_data_dir", shards[0])
    assert len(served) == 2 and closed
    assert "native loader: 37 prompts" in caplog.text

    served.clear()
    caplog.clear()
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "library_path", lambda: tmp_path / "absent" / "lib.so")
    monkeypatch.setattr(tloader.shutil, "which", lambda name: None)
    with caplog.at_level(logging.INFO, logger="tdm_tpu_torch"):
        _cli(tmp_path / "py", "--train_data_dir", shards[0])
    assert not served
    assert "native loader unavailable (no g++ on PATH" in caplog.text
