from tdm_tpu_torch.pipelines.base import PipelineOutput
from tdm_tpu_torch.pipelines.loading import from_pretrained, save_pretrained
from tdm_tpu_torch.pipelines.pixart import PixArtPipeline
from tdm_tpu_torch.pipelines.sd15 import SD15Pipeline

__all__ = ["PipelineOutput", "PixArtPipeline", "SD15Pipeline", "from_pretrained",
           "save_pretrained"]
