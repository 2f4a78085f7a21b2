from repro_torch.core.stats import ActivationStats, entropy, lemma1_coverage_bound
from repro_torch.core.placement import (allocate_expert_counts, assign_experts_layer,
                                  dancemoe_placement, build_ep_placement,
                                  PlacementPlan, remote_cost, local_utility)
from repro_torch.core.baselines import (uniform_plan, redundance_plan,
                                  smartmoe_plan, eplb_plan)
from repro_torch.core.migration import (CostModel, MigrationController,
                                  migration_time, should_migrate)
from repro_torch.core.policies import (ClusterView, PlacementController,
                                 PlacementDecision, PlacementPolicy,
                                 as_policy, get_policy, list_policies,
                                 register_policy)
