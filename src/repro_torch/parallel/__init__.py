from repro_torch.parallel.sharding import (
    ShardingRules,
    rules_for,
    logical_to_spec,
    spec_tree,
    named_sharding_tree,
    constrainer,
)
