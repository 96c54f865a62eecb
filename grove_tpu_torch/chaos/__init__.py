from grove_tpu_torch.chaos.scenario import run_prefill_replica_kill

__all__ = ["run_prefill_replica_kill"]
