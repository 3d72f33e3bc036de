"""Multi-device layouts (counterpart of ``cachedembedding_tpu/parallel/``):
the sharding planner, the process-group mesh, the collectives every layout
shares and the column-wise cached embedding. Ranks are processes joined by
``torch.distributed`` (NCCL on the card, gloo on the CPU)."""
