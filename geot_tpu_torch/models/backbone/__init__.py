"""Encoders and their modules. The reference's ``pointnet2_modules``
surface: the SA and FP aliases of ``pointnetv2`` and VoteNet's SA modules
(``pointnet2_votes``), as ``geot_tpu.models.backbone`` exports them."""
from .pointnetv2 import (PointnetFPModule, PointNetFeaturePropagation,
                         PointnetSAModule, PointnetSAModuleMSG)
from .pointnet2_votes import (PointnetLFPModuleMSG, PointnetSAModuleMSGVotes,
                              PointnetSAModuleVotes,
                              PointnetSAModuleVotes_nofps,
                              PointnetSAModuleVotes_nogrouping)

__all__ = ["PointnetSAModule", "PointnetSAModuleMSG", "PointnetFPModule",
           "PointNetFeaturePropagation", "PointnetSAModuleVotes",
           "PointnetSAModuleVotes_nofps", "PointnetSAModuleVotes_nogrouping",
           "PointnetSAModuleMSGVotes", "PointnetLFPModuleMSG"]
