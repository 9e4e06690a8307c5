from tdm_tpu_torch.eval.clip_score import CLIPScorer, preprocess_images  # noqa: F401

# the scoring function itself is tdm_tpu_torch.eval.clip_score.clip_score:
# re-exported here, its name would shadow the submodule
