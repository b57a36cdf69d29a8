"""Training substrate, ported (``repro.train``): the optimizer, the LM
training step, the int8 ring all-reduce (``collectives``) and pod-compressed
data parallelism over ``torch.distributed`` (``pod_compress``)."""
