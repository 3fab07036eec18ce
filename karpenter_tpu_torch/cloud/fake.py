"""Fake cloud provider — the test double the whole tier-1 strategy rests on.

Ports the *semantics* of pkg/fake/ec2api.go (584 LoC of fakes; SURVEY.md §4):
in-memory instances, call capture, error/ICE injection per offering, eventual
consistency (instances invisible for the first N get/list calls, mirroring the
DescribeInstances retry loop at instance.go:99-107), and capacity tracking so
tests can assert exactly what got launched.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..models import labels as L
from ..models.instancetype import InstanceType, specialize_for_kubelet
from ..models.machine import Machine
from ..models.provisioner import Provisioner
from ..utils.clock import Clock
from .base import (
    CloudProvider,
    InsufficientCapacityError,
    MachineNotFoundError,
)
from .launchpath import select_launch_types
from .templates import (
    Image,
    LaunchTemplateProvider,
    NodeTemplate,
    images_for_instance_type,
    resolve_images,
)

_instance_counter = itertools.count()


@dataclass
class FakeInstance:
    provider_id: str
    machine: Machine
    created_at: float
    visible_after_calls: int = 0  # eventual-consistency countdown
    terminated: bool = False
    drifted: bool = False
    tags: Dict[str, str] = field(default_factory=dict)


class FakeCloudProvider(CloudProvider):
    def __init__(
        self,
        instance_types: Sequence[InstanceType],
        clock: Optional[Clock] = None,
        eventual_consistency_calls: int = 0,
    ) -> None:
        self.instance_types = list(instance_types)
        self.clock = clock or Clock()
        self.eventual_consistency_calls = eventual_consistency_calls
        self.instances: Dict[str, FakeInstance] = {}
        # image catalog + node templates back the real drift check
        # (cloudprovider.go:258-287): creates stamp machine.image_id from the
        # template's currently-resolved images; publishing a newer image later
        # makes existing machines drift.
        self.templates: Dict[str, NodeTemplate] = {"default": NodeTemplate()}
        self.images: List[Image] = []
        # named pre-built launch templates (launch_template_name override):
        # LT name -> image id it launches with
        self.launch_templates: Dict[str, str] = {}
        self.fleet_calls = 0  # one per create_fleet round trip
        self.ice_offerings: Set[Tuple[str, str, str]] = set()  # (type, zone, ct)
        self.create_calls: List[Machine] = []
        self.delete_calls: List[str] = []
        self.launch_selections: List = []  # LaunchSelection per create (call capture)
        self.next_error: Optional[Exception] = None
        self.allow_creates = True
        # seconds until a launched node registers + passes readiness; >0
        # engages the deprovisioning wait-ready machine for replacements
        self.node_ready_delay: float = 0.0
        # global settings consumed at launch (configure_settings); the
        # launch-template flow (create -> ensure LT -> fleet) consumes
        # clusterEndpoint (bootstrap userdata) + defaultInstanceProfile,
        # and owns the single copy of cluster_name (see property below)
        self.launch_template_provider = LaunchTemplateProvider("sim")
        self.default_tags: Dict[str, str] = {}
        self.node_name_convention = "ip-name"

    @property
    def cluster_name(self) -> str:
        # single source of truth: instance tagging and bootstrap userdata
        # must never disagree on the cluster name
        return self.launch_template_provider.cluster_name

    @cluster_name.setter
    def cluster_name(self, value: str) -> None:
        self.launch_template_provider.cluster_name = value

    def configure_settings(self, settings) -> None:
        """settings.go:40-65 consumption: cluster name + default tags flow
        into instance tagging, nodeNameConvention into node naming, cluster
        endpoint + default instance profile into the launch templates."""
        self.default_tags = dict(settings.tags)
        self.node_name_convention = settings.node_name_convention
        ltp = self.launch_template_provider
        ltp.cluster_name = settings.cluster_name
        ltp.cluster_endpoint = settings.cluster_endpoint
        ltp.default_instance_profile = settings.default_instance_profile

    def _node_name(self, seq: int) -> str:
        """Node object name per nodeNameConvention (settings.go:52):
        'ip-name' mirrors EC2 private-DNS naming, 'resource-name' names the
        node after the instance id."""
        if self.node_name_convention == "resource-name":
            return f"i-{seq:017d}"
        # 24 bits of address space: node names key state dicts, so a long
        # simulation must not wrap into duplicate names
        return f"ip-10-{(seq >> 16) & 0xFF}-{(seq >> 8) & 0xFF}-{seq & 0xFF}"

    # ---- test injection ------------------------------------------------
    def inject_ice(self, instance_type: str, zone: str, capacity_type: str) -> None:
        self.ice_offerings.add((instance_type, zone, capacity_type))

    def clear_ice(self) -> None:
        self.ice_offerings.clear()

    def mark_drifted(self, provider_id: str) -> None:
        self.instances[provider_id].drifted = True

    def publish_image(self, image: Image) -> None:
        """Add an image to the catalog (the SSM-alias-update analog: a newer
        image per (family, arch, accel) supersedes the old in resolution)."""
        self.images.append(image)

    def register_launch_template(self, name: str, image_id: str) -> None:
        """Register a pre-built launch template for launch_template_name
        overrides (the user-managed LT the reference launches verbatim)."""
        self.launch_templates[name] = image_id

    # ---- CloudProvider -------------------------------------------------
    def create(self, machine: Machine) -> Machine:
        self.create_calls.append(machine)
        if self.next_error is not None:
            err, self.next_error = self.next_error, None
            raise err
        if not self.allow_creates:
            raise RuntimeError("creates disabled")

        # full reference launch pipeline (filter -> price-sort -> 60-cap ->
        # capacity-type choice), then fleet semantics: walk offerings of the
        # chosen capacity type cheapest-first, skipping ICE'd pools the way
        # CreateFleet's lowest-price strategy tries the next pool
        # (instance.go:83-87,201-259,405-529)
        sel = select_launch_types(machine, self.instance_types)
        machine.launch_warnings = list(sel.warnings)
        self.launch_selections.append(sel)
        choice, iced = self._resolve_fleet(machine, sel)
        if choice is None:
            if iced:
                # every matching pool is ICE'd: surface the cheapest one's
                # coordinates (what a CreateFleet ICE error carries)
                it0, o0 = iced[0]
                raise InsufficientCapacityError(it0.name, o0.zone, o0.capacity_type)
            wanted = sorted(machine.requirements.get(L.INSTANCE_TYPE).values)
            raise InsufficientCapacityError(wanted[0] if wanted else "<any>", "<any>", "<any>")
        it, offering = choice
        # ICE'd pools skipped on the way to success still get reported so the
        # controller can blacklist them (instance.go:395-401)
        machine.ice_errors = [(i.name, o.zone, o.capacity_type) for i, o in iced]

        seq = next(_instance_counter)
        pid = f"fake://{it.name}/{seq}"
        machine.provider_id = pid
        machine.node_name = self._node_name(seq)
        machine.image_id = self._image_for(machine.node_template, it)
        machine.instance_type = it.name
        machine.zone = offering.zone
        machine.capacity_type = offering.capacity_type
        machine.price = offering.price
        # the machine's kubeletConfiguration changes real node capacity
        # (instancetype.go:226-340): density + reservation overrides are
        # applied here exactly as the solver's candidate rows assumed
        it_eff = specialize_for_kubelet(it, machine.kubelet)
        machine.capacity = dict(it_eff.capacity)
        machine.allocatable = dict(it_eff.allocatable)
        machine.launched_at = self.clock.now()
        tmpl = self.templates.get(machine.node_template)
        if tmpl is not None and tmpl.launch_template_name is None and machine.image_id:
            # the reference ensures a launch template before CreateFleet
            # (launchtemplate.go EnsureAll): this is where clusterEndpoint
            # (bootstrap userdata) and defaultInstanceProfile are consumed.
            # Keyed on the PRE-resolution labels (the provisioner's static
            # set) — zone/type/capacity-type are fleet overrides, not
            # userdata, so LT cardinality stays per (template, image), not
            # per (catalog x zones x capacity-types)
            lt = self.launch_template_provider.ensure(
                tmpl,
                Image(machine.image_id, it.labels().get(L.ARCH, "")),
                labels=machine.labels, taints=machine.taints,
                kubelet_flags=(
                    machine.kubelet.bootstrap_flags() if machine.kubelet else None
                ),
            )
            machine.launch_template = lt.name
        machine.labels = {
            **machine.labels,
            **it.labels(),
            L.ZONE: offering.zone,
            L.CAPACITY_TYPE: offering.capacity_type,
            L.INSTANCE_TYPE: it.name,
            L.PROVISIONER_NAME: machine.provisioner,
        }
        self.instances[pid] = FakeInstance(
            provider_id=pid,
            machine=machine,
            created_at=self.clock.now(),
            visible_after_calls=self.eventual_consistency_calls,
            # tag layering: settings-wide defaults, then the template's own,
            # then the karpenter ownership/attribution tags LAST — user tags
            # must never override them (instance.go:216-218; settings tag
            # validation also rejects the reserved prefixes)
            tags={
                **self.default_tags,
                **(tmpl.tags if tmpl else {}),
                f"kubernetes.io/cluster/{self.cluster_name}": "owned",
                "karpenter.sh/provisioner-name": machine.provisioner,
            },
        )
        return machine

    def _resolve_fleet(self, machine: Machine, sel):
        """Fleet launch over the selected types: cheapest non-ICE'd pool of
        the chosen capacity type wins; ICE'd pools encountered cheaper than
        the winner are collected (price-ordered) for blacklist feedback."""
        reqs = machine.requirements
        zone_req = reqs.get(L.ZONE)
        pools = []
        for it in sel.instance_types:
            for o in it.offerings:
                if not o.available or o.capacity_type != sel.capacity_type:
                    continue
                if not zone_req.contains(o.zone):
                    continue
                pools.append((it, o))
        pools.sort(key=lambda p: (p[1].price, p[0].name, p[1].zone))
        iced = []
        for it, o in pools:
            if (it.name, o.zone, o.capacity_type) in self.ice_offerings:
                iced.append((it, o))
                continue
            return (it, o), iced
        return None, iced

    def delete(self, machine: Machine) -> None:
        self.delete_calls.append(machine.provider_id)
        inst = self.instances.get(machine.provider_id)
        if inst is None or inst.terminated:
            raise MachineNotFoundError(machine.provider_id)
        inst.terminated = True

    def get(self, provider_id: str) -> Machine:
        inst = self.instances.get(provider_id)
        if inst is None or inst.terminated:
            raise MachineNotFoundError(provider_id)
        if inst.visible_after_calls > 0:
            inst.visible_after_calls -= 1
            raise MachineNotFoundError(f"{provider_id} (eventual consistency)")
        return inst.machine

    def list(self) -> List[Machine]:
        out = []
        for inst in self.instances.values():
            if inst.terminated:
                continue
            if inst.visible_after_calls > 0:
                inst.visible_after_calls -= 1
                continue
            out.append(inst.machine)
        return out

    def get_instance_types(self, provisioner: Optional[Provisioner] = None) -> List[InstanceType]:
        return list(self.instance_types)

    def create_fleet(self, machines: Sequence[Machine]) -> List[object]:
        """Bulk create: ONE fleet round trip launches every machine
        (CreateFleet with summed capacity, createfleet.go fan-out).  Returns
        one slot per machine — the launched Machine, or the per-pool error —
        so callers see partial fulfilment exactly like a real fleet."""
        self.fleet_calls += 1
        out: List[object] = []
        for m in machines:
            try:
                out.append(self.create(m))
            # ktlint: allow[KT005] fleet partial-fulfilment contract: the
            # per-pool error IS the result slot (createfleet.go semantics)
            except Exception as err:
                out.append(err)
        return out

    def _image_for(self, template_name: str, it: InstanceType) -> str:
        tmpl = self.templates.get(template_name)
        if tmpl is None:
            return ""
        if tmpl.launch_template_name is not None:
            # user-managed LT launched verbatim: the image is whatever the
            # named template carries (instance.go launch-template override)
            return self.launch_templates.get(tmpl.launch_template_name, "")
        images = resolve_images(tmpl, self.images)
        mapped = images_for_instance_type(images, it)
        return mapped[0].image_id if mapped else ""

    def is_machine_drifted(self, machine: Machine) -> bool:
        """Real image drift (cloudprovider.go:233-251 + isAMIDrifted
        :258-287): the instance's image must be among the images the node
        template *currently* resolves for its instance type.  The injected
        `drifted` flag remains as a test escape hatch."""
        inst = self.instances.get(machine.provider_id)
        if inst is None:
            return False
        if inst.drifted:
            return True
        if not machine.image_id or not machine.instance_type:
            return False  # drift not detectable without a recorded image
        tmpl = self.templates.get(machine.node_template)
        if tmpl is None:
            return False
        if tmpl.launch_template_name is not None:
            # LT override: drift when the user repointed the named template
            # at a different image
            current = self.launch_templates.get(tmpl.launch_template_name, "")
            return bool(current) and machine.image_id != current
        it = next(
            (t for t in self.instance_types if t.name == machine.instance_type), None
        )
        if it is None:
            return False
        images = resolve_images(tmpl, self.images)
        mapped = {i.image_id for i in images_for_instance_type(images, it)}
        return machine.image_id not in mapped

    def name(self) -> str:
        return "fake"
