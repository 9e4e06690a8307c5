"""Multi-GPU training and serving of the port: process groups, the
('data', 'fsdp') mesh, the gradient mean and ZeRO-3 (`parallel/mesh.py`)."""
