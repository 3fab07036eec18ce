# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: solver.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0csolver.proto\x12\rkarpenter.tpu"+\n\x08Quantity\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01"6\n\x0bRequirement\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\n\n\x02op\x18\x02 \x01(\t\x12\x0e\n\x06values\x18\x03 \x03(\t"C\n\x0fRequirementTerm\x120\n\x0crequirements\x18\x01 \x03(\x0b2\x1a.karpenter.tpu.Requirement"D\n\nToleration\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\n\n\x02op\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x12\x0e\n\x06effect\x18\x04 \x01(\t"3\n\x05Taint\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x0e\n\x06effect\x18\x03 \x01(\t"\xbf\x01\n\rLabelSelector\x12C\n\x0cmatch_labels\x18\x01 \x03(\x0b2-.karpenter.tpu.LabelSelector.MatchLabelsEntry\x125\n\x11match_expressions\x18\x02 \x03(\x0b2\x1a.karpenter.tpu.Requirement\x1a2\n\x10MatchLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"v\n\x0eTopologySpread\x12\x10\n\x08max_skew\x18\x01 \x01(\x05\x12\x14\n\x0ctopology_key\x18\x02 \x01(\t\x12\x0c\n\x04hard\x18\x03 \x01(\x08\x12.\n\x08selector\x18\x04 \x01(\x0b2\x1c.karpenter.tpu.LabelSelector"b\n\x0cAffinityTerm\x12.\n\x08selector\x18\x01 \x01(\x0b2\x1c.karpenter.tpu.LabelSelector\x12\x14\n\x0ctopology_key\x18\x02 \x01(\t\x12\x0c\n\x04anti\x18\x03 \x01(\x08"\x97\x05\n\x03Pod\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12.\n\x06labels\x18\x03 \x03(\x0b2\x1e.karpenter.tpu.Pod.LabelsEntry\x12)\n\x08requests\x18\x04 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12;\n\rnode_selector\x18\x05 \x03(\x0b2$.karpenter.tpu.Pod.NodeSelectorEntry\x129\n\x11required_affinity\x18\x06 \x03(\x0b2\x1e.karpenter.tpu.RequirementTerm\x12.\n\x0btolerations\x18\x07 \x03(\x0b2\x19.karpenter.tpu.Toleration\x12-\n\x06spread\x18\x08 \x03(\x0b2\x1d.karpenter.tpu.TopologySpread\x12-\n\x08affinity\x18\t \x03(\x0b2\x1b.karpenter.tpu.AffinityTerm\x12\x10\n\x08priority\x18\n \x01(\x05\x12\x15\n\rdeletion_cost\x18\x0b \x01(\x01\x12\r\n\x05owner\x18\x0c \x01(\t\x12<\n\x18volume_zone_requirements\x18\r \x03(\x0b2\x1a.karpenter.tpu.Requirement\x12\x17\n\x07gang_id\x18\x0e \x01(\tR\x06gangId\x12\x1b\n\tgang_size\x18\x0f \x01(\x05R\x08gangSize\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01\x1a3\n\x11NodeSelectorEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"Q\n\x08Offering\x12\x0c\n\x04zone\x18\x01 \x01(\t\x12\x15\n\rcapacity_type\x18\x02 \x01(\t\x12\r\n\x05price\x18\x03 \x01(\x01\x12\x11\n\tavailable\x18\x04 \x01(\x08"\x87\x03\n\x0cInstanceType\x12\x0c\n\x04name\x18\x01 \x01(\t\x120\n\x0crequirements\x18\x02 \x03(\x0b2\x1a.karpenter.tpu.Requirement\x12*\n\tofferings\x18\x03 \x03(\x0b2\x17.karpenter.tpu.Offering\x12)\n\x08capacity\x18\x04 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12)\n\x08overhead\x18\x05 \x03(\x0b2\x17.karpenter.tpu.Quantity\x120\n\x0foverhead_system\x18\x06 \x03(\x0b2\x17.karpenter.tpu.Quantity\x122\n\x11overhead_eviction\x18\x07 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12.\n\roverhead_kube\x18\x08 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12\x1f\n\x17has_overhead_components\x18\t \x01(\x08"\xd8\x03\n\x14KubeletConfiguration\x12\x14\n\x0chas_max_pods\x18\x01 \x01(\x08\x12\x10\n\x08max_pods\x18\x02 \x01(\x05\x12\x19\n\x11has_pods_per_core\x18\x03 \x01(\x08\x12\x15\n\rpods_per_core\x18\x04 \x01(\x05\x120\n\x0fsystem_reserved\x18\x05 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12.\n\rkube_reserved\x18\x06 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12L\n\reviction_hard\x18\x07 \x03(\x0b25.karpenter.tpu.KubeletConfiguration.EvictionHardEntry\x12L\n\reviction_soft\x18\x08 \x03(\x0b25.karpenter.tpu.KubeletConfiguration.EvictionSoftEntry\x1a3\n\x11EvictionHardEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01\x1a3\n\x11EvictionSoftEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\x96\x03\n\x0bProvisioner\x12\x0c\n\x04name\x18\x01 \x01(\t\x120\n\x0crequirements\x18\x02 \x03(\x0b2\x1a.karpenter.tpu.Requirement\x12$\n\x06taints\x18\x03 \x03(\x0b2\x14.karpenter.tpu.Taint\x12,\n\x0estartup_taints\x18\x04 \x03(\x0b2\x14.karpenter.tpu.Taint\x126\n\x06labels\x18\x05 \x03(\x0b2&.karpenter.tpu.Provisioner.LabelsEntry\x12\'\n\x06limits\x18\x06 \x03(\x0b2\x17.karpenter.tpu.Quantity\x12\x0e\n\x06weight\x18\x07 \x01(\x05\x12\x1d\n\x15consolidation_enabled\x18\x08 \x01(\x08\x124\n\x07kubelet\x18\t \x01(\x0b2#.karpenter.tpu.KubeletConfiguration\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\xda\x02\n\x0cExistingNode\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x15\n\rinstance_type\x18\x02 \x01(\t\x12\x13\n\x0bprovisioner\x18\x03 \x01(\t\x12\x0c\n\x04zone\x18\x04 \x01(\t\x12\x15\n\rcapacity_type\x18\x05 \x01(\t\x12\r\n\x05price\x18\x06 \x01(\x01\x12,\n\x0ballocatable\x18\x07 \x03(\x0b2\x17.karpenter.tpu.Quantity\x127\n\x06labels\x18\x08 \x03(\x0b2\'.karpenter.tpu.ExistingNode.LabelsEntry\x12$\n\x06taints\x18\t \x03(\x0b2\x14.karpenter.tpu.Taint\x12 \n\x04pods\x18\n \x03(\x0b2\x12.karpenter.tpu.Pod\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"Q\n\x13UnavailableOffering\x12\x15\n\rinstance_type\x18\x01 \x01(\t\x12\x0c\n\x04zone\x18\x02 \x01(\t\x12\x15\n\rcapacity_type\x18\x03 \x01(\t"\xdc\x05\n\x0cSolveRequest\x12 \n\x04pods\x18\x01 \x03(\x0b2\x12.karpenter.tpu.Pod\x120\n\x0cprovisioners\x18\x02 \x03(\x0b2\x1a.karpenter.tpu.Provisioner\x123\n\x0einstance_types\x18\x03 \x03(\x0b2\x1b.karpenter.tpu.InstanceType\x123\n\x0eexisting_nodes\x18\x04 \x03(\x0b2\x1b.karpenter.tpu.ExistingNode\x12&\n\ndaemonsets\x18\x05 \x03(\x0b2\x12.karpenter.tpu.Pod\x127\n\x0bunavailable\x18\x06 \x03(\x0b2".karpenter.tpu.UnavailableOffering\x12\x17\n\x0fallow_new_nodes\x18\x07 \x01(\x08\x12\x19\n\x11has_max_new_nodes\x18\x08 \x01(\x08\x12\x15\n\rmax_new_nodes\x18\t \x01(\x05\x12\x0f\n\x07backend\x18\n \x01(\t\x12\x16\n\x0epriority_class\x18\x0b \x01(\t\x12\x13\n\x0bdeadline_ms\x18\x0c \x01(\x01\x12\x1d\n\nsession_id\x18\r \x01(\tR\tsessionId\x12\x1d\n\nbase_epoch\x18\x0e \x01(\x03R\tbaseEpoch\x12\x14\n\x05delta\x18\x0f \x01(\x08R\x05delta\x12!\n\x0cremoved_pods\x18\x10 \x03(\tR\x0bremovedPods\x12\'\n\x0freclaimed_nodes\x18\x11 \x03(\tR\x0ereclaimedNodes\x12#\n\rcatalog_epoch\x18\x12 \x01(\x03R\x0ccatalogEpoch\x12\x19\n\x08trace_id\x18\x13 \x01(\tR\x07traceId\x12\x1f\n\x0bparent_span\x18\x14 \x01(\tR\nparentSpan\x12#\n\rsession_nonce\x18\x15 \x01(\tR\x0csessionNonce"\x8a\x01\n\x07NewNode\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x15\n\rinstance_type\x18\x02 \x01(\t\x12\x13\n\x0bprovisioner\x18\x03 \x01(\t\x12\x0c\n\x04zone\x18\x04 \x01(\t\x12\x15\n\rcapacity_type\x18\x05 \x01(\t\x12\r\n\x05price\x18\x06 \x01(\x01\x12\x11\n\tpod_names\x18\x07 \x03(\t"\x87\x04\n\rSolveResponse\x12%\n\x05nodes\x18\x01 \x03(\x0b2\x16.karpenter.tpu.NewNode\x12B\n\x0bassignments\x18\x02 \x03(\x0b2-.karpenter.tpu.SolveResponse.AssignmentsEntry\x12@\n\ninfeasible\x18\x03 \x03(\x0b2,.karpenter.tpu.SolveResponse.InfeasibleEntry\x12\x10\n\x08solve_ms\x18\x04 \x01(\x01\x12#\n\rsession_epoch\x18\x05 \x01(\x03R\x0csessionEpoch\x12#\n\rsession_state\x18\x06 \x01(\tR\x0csessionState\x12\x1d\n\ndelta_mode\x18\x07 \x01(\tR\tdeltaMode\x12#\n\rremoved_nodes\x18\x08 \x03(\tR\x0cremovedNodes\x12\x1d\n\nreplica_id\x18\t \x01(\tR\treplicaId\x12#\n\rsession_nonce\x18\n \x01(\tR\x0csessionNonce\x1a2\n\x10AssignmentsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01\x1a1\n\x0fInfeasibleEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"\xe2\x01\n\x0bWarmRequest\x120\n\x0cprovisioners\x18\x01 \x03(\x0b2\x1a.karpenter.tpu.Provisioner\x123\n\x0einstance_types\x18\x02 \x03(\x0b2\x1b.karpenter.tpu.InstanceType\x12&\n\ndaemonsets\x18\x03 \x03(\x0b2\x12.karpenter.tpu.Pod\x123\n\x0eexisting_nodes\x18\x04 \x03(\x0b2\x1b.karpenter.tpu.ExistingNode\x12\x0f\n\x07backend\x18\x05 \x01(\t"\x1f\n\x0cWarmResponse\x12\x0f\n\x07started\x18\x01 \x01(\x05"\x0f\n\rHealthRequest">\n\x0eHealthResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07backend\x18\x02 \x01(\t\x12\x0f\n\x07devices\x18\x03 \x01(\x05b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'solver_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LABELSELECTOR_MATCHLABELSENTRY._options = None
  _LABELSELECTOR_MATCHLABELSENTRY._serialized_options = b'8\001'
  _POD_LABELSENTRY._options = None
  _POD_LABELSENTRY._serialized_options = b'8\001'
  _POD_NODESELECTORENTRY._options = None
  _POD_NODESELECTORENTRY._serialized_options = b'8\001'
  _KUBELETCONFIGURATION_EVICTIONHARDENTRY._options = None
  _KUBELETCONFIGURATION_EVICTIONHARDENTRY._serialized_options = b'8\001'
  _KUBELETCONFIGURATION_EVICTIONSOFTENTRY._options = None
  _KUBELETCONFIGURATION_EVICTIONSOFTENTRY._serialized_options = b'8\001'
  _PROVISIONER_LABELSENTRY._options = None
  _PROVISIONER_LABELSENTRY._serialized_options = b'8\001'
  _EXISTINGNODE_LABELSENTRY._options = None
  _EXISTINGNODE_LABELSENTRY._serialized_options = b'8\001'
  _SOLVERESPONSE_ASSIGNMENTSENTRY._options = None
  _SOLVERESPONSE_ASSIGNMENTSENTRY._serialized_options = b'8\001'
  _SOLVERESPONSE_INFEASIBLEENTRY._options = None
  _SOLVERESPONSE_INFEASIBLEENTRY._serialized_options = b'8\001'
  _QUANTITY._serialized_start=31
  _QUANTITY._serialized_end=74
  _REQUIREMENT._serialized_start=76
  _REQUIREMENT._serialized_end=130
  _REQUIREMENTTERM._serialized_start=132
  _REQUIREMENTTERM._serialized_end=199
  _TOLERATION._serialized_start=201
  _TOLERATION._serialized_end=269
  _TAINT._serialized_start=271
  _TAINT._serialized_end=322
  _LABELSELECTOR._serialized_start=325
  _LABELSELECTOR._serialized_end=516
  _LABELSELECTOR_MATCHLABELSENTRY._serialized_start=466
  _LABELSELECTOR_MATCHLABELSENTRY._serialized_end=516
  _TOPOLOGYSPREAD._serialized_start=518
  _TOPOLOGYSPREAD._serialized_end=636
  _AFFINITYTERM._serialized_start=638
  _AFFINITYTERM._serialized_end=736
  _POD._serialized_start=739
  _POD._serialized_end=1402
  _POD_LABELSENTRY._serialized_start=1304
  _POD_LABELSENTRY._serialized_end=1349
  _POD_NODESELECTORENTRY._serialized_start=1351
  _POD_NODESELECTORENTRY._serialized_end=1402
  _OFFERING._serialized_start=1404
  _OFFERING._serialized_end=1485
  _INSTANCETYPE._serialized_start=1488
  _INSTANCETYPE._serialized_end=1879
  _KUBELETCONFIGURATION._serialized_start=1882
  _KUBELETCONFIGURATION._serialized_end=2354
  _KUBELETCONFIGURATION_EVICTIONHARDENTRY._serialized_start=2250
  _KUBELETCONFIGURATION_EVICTIONHARDENTRY._serialized_end=2301
  _KUBELETCONFIGURATION_EVICTIONSOFTENTRY._serialized_start=2303
  _KUBELETCONFIGURATION_EVICTIONSOFTENTRY._serialized_end=2354
  _PROVISIONER._serialized_start=2357
  _PROVISIONER._serialized_end=2763
  _PROVISIONER_LABELSENTRY._serialized_start=1304
  _PROVISIONER_LABELSENTRY._serialized_end=1349
  _EXISTINGNODE._serialized_start=2766
  _EXISTINGNODE._serialized_end=3112
  _EXISTINGNODE_LABELSENTRY._serialized_start=1304
  _EXISTINGNODE_LABELSENTRY._serialized_end=1349
  _UNAVAILABLEOFFERING._serialized_start=3114
  _UNAVAILABLEOFFERING._serialized_end=3195
  _SOLVEREQUEST._serialized_start=3198
  _SOLVEREQUEST._serialized_end=3930
  _NEWNODE._serialized_start=3933
  _NEWNODE._serialized_end=4071
  _SOLVERESPONSE._serialized_start=4074
  _SOLVERESPONSE._serialized_end=4593
  _SOLVERESPONSE_ASSIGNMENTSENTRY._serialized_start=4492
  _SOLVERESPONSE_ASSIGNMENTSENTRY._serialized_end=4542
  _SOLVERESPONSE_INFEASIBLEENTRY._serialized_start=4544
  _SOLVERESPONSE_INFEASIBLEENTRY._serialized_end=4593
  _WARMREQUEST._serialized_start=4596
  _WARMREQUEST._serialized_end=4822
  _WARMRESPONSE._serialized_start=4824
  _WARMRESPONSE._serialized_end=4855
  _HEALTHREQUEST._serialized_start=4857
  _HEALTHREQUEST._serialized_end=4872
  _HEALTHRESPONSE._serialized_start=4874
  _HEALTHRESPONSE._serialized_end=4936
# @@protoc_insertion_point(module_scope)
