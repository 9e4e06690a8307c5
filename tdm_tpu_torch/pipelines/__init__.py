from tdm_tpu_torch.pipelines.base import PipelineOutput
from tdm_tpu_torch.pipelines.loading import from_pretrained, save_pretrained
from tdm_tpu_torch.pipelines.pixart import PixArtPipeline

__all__ = ["PipelineOutput", "PixArtPipeline", "from_pretrained", "save_pretrained"]
