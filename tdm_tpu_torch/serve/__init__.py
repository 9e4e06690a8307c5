from tdm_tpu_torch.serve.batcher import MicroBatcher, Overloaded, ServeStats, latent_shape
from tdm_tpu_torch.serve.server import TDMServer

__all__ = ["MicroBatcher", "Overloaded", "ServeStats", "TDMServer", "latent_shape"]
