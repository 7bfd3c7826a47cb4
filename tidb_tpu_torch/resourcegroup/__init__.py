"""Resource control (ref: pkg/resourcegroup + resourcemanager): resource
groups with RU token buckets and runaway-query rules (runaway/checker.go:35,
hooked at the statement boundary like adapter.go:553-560)."""

from tidb_tpu_torch.resourcegroup.groups import ResourceGroup, ResourceGroupManager, RunawayRecord

__all__ = ["ResourceGroup", "ResourceGroupManager", "RunawayRecord"]
