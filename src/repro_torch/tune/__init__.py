"""Schedule autotuner (the port of the reference's ``repro.tune``):
analytic pruning over the Eq. 2/3 time model, traced-simulator validation
with batched candidate replay, and time/cost/accuracy Pareto fronts over
``ScheduleSpec`` search spaces."""
from repro_torch.tune.autotune import (Candidate, TuneProblem, TuneResult,
                                       autotune, dominates, pareto_front,
                                       predicted_schedule_time,
                                       schedule_cost)
from repro_torch.tune.space import SearchSpace
from repro_torch.tune.tables import (base_spec, combined_space, table3_space,
                                     table5_space, table8_space,
                                     union_candidates)

__all__ = [
    "Candidate", "SearchSpace", "TuneProblem", "TuneResult", "autotune",
    "base_spec", "combined_space", "dominates", "pareto_front",
    "predicted_schedule_time", "schedule_cost", "table3_space",
    "table5_space", "table8_space", "union_candidates",
]
