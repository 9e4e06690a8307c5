from tdm_tpu_torch.pipelines.base import PipelineOutput
from tdm_tpu_torch.pipelines.cogvideox import CogVideoXPipeline
from tdm_tpu_torch.pipelines.loading import from_pretrained, save_pretrained
from tdm_tpu_torch.pipelines.pixart import PixArtPipeline, default_pixart_pipeline
from tdm_tpu_torch.pipelines.sd15 import SD15Pipeline

__all__ = ["CogVideoXPipeline", "PipelineOutput", "PixArtPipeline", "SD15Pipeline",
           "default_pixart_pipeline", "from_pretrained", "save_pretrained"]
