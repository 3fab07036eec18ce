"""NodeTemplate controller — reconciles template status with discovered
subnets, security groups, and images (pkg/controllers/nodetemplate/
controller.go:41-112, 5-minute resync)."""

from __future__ import annotations

from typing import Dict, Optional

from ..cloud.templates import NodeTemplate, resolve_images
from ..providers.securitygroup import SecurityGroupProvider
from ..providers.subnet import SubnetProvider
from ..utils.clock import Clock

RESYNC_PERIOD = 5 * 60.0


class NodeTemplateController:
    def __init__(
        self,
        subnets: SubnetProvider,
        security_groups: SecurityGroupProvider,
        clock: Optional[Clock] = None,
    ) -> None:
        self.templates: Dict[str, NodeTemplate] = {}
        self.subnets = subnets
        self.security_groups = security_groups
        self.clock = clock or Clock()
        self._last_sync = -1e18

    def apply(self, template: NodeTemplate) -> None:
        from ..webhooks import admit_node_template

        admit_node_template(template)  # raises AdmissionError
        self.templates[template.name] = template
        self._reconcile_one(template)

    def get(self, name: str) -> Optional[NodeTemplate]:
        return self.templates.get(name)

    def reconcile(self, force: bool = False) -> None:
        now = self.clock.now()
        if not force and now - self._last_sync < RESYNC_PERIOD:
            return
        self._last_sync = now
        for t in self.templates.values():
            self._reconcile_one(t)

    def _reconcile_one(self, t: NodeTemplate) -> None:
        t.status_subnets = [
            s.subnet_id for s in self.subnets.list(t.subnet_selector)
        ]
        t.status_security_groups = [
            g.group_id for g in self.security_groups.list(t.security_group_selector)
        ]
        t.status_images = resolve_images(t)
