"""Failure-recovery control plane for the serving stack.

  faults    seeded virtual-clock FaultInjector (crash / transient / slow /
            stats-corruption), bit-identical when inert
  retry     per-query retry ladder: stage resume -> OOM fallback replan ->
            degradation-ladder handoff -> give up
  hedge     speculative execution for overrunning stragglers
  breaker   post-swap circuit breaker on the PolicyStore
  manager   RecoveryManager: wires all of it into one LaneScheduler run

See serve/README.md for the dataflow and failure-semantics table.
"""
from repro_torch.serve.recover.breaker import PolicyBreaker
from repro_torch.serve.recover.faults import (FaultEvent, FaultInjector, RunFaults,
                                        ScriptedFaults)
from repro_torch.serve.recover.hedge import HedgePolicy
from repro_torch.serve.recover.manager import RecoveryManager, RecoveryStats
from repro_torch.serve.recover.retry import (RetryPolicy, RetryTicket,
                                       fallback_plan)

__all__ = ["FaultEvent", "FaultInjector", "RunFaults", "ScriptedFaults",
           "RetryPolicy", "RetryTicket", "fallback_plan", "HedgePolicy",
           "PolicyBreaker", "RecoveryManager", "RecoveryStats"]
