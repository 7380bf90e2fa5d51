"""Multi-GPU receive over ``torch.distributed``: station × time sharding
(:mod:`.receive`), the frontend | FEC stage pipeline (:mod:`.pipeline`),
capture replay through the host transport (:mod:`.replay`) and the
multi-process runs (:mod:`.distributed`)."""
