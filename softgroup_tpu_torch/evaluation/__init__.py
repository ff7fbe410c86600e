"""evaluation of the PyTorch/CUDA port (see the package docstring): the
ScanNet instance and SemanticKITTI panoptic protocols, the point-wise
metrics, the host postprocess and the benchmark's I/O."""

from .instance_eval import ScanNetEval
from .instance_eval_util import (Instance, export_ids,
                                 export_instance_ids_for_eval, load_ids,
                                 read_instance_prediction_file,
                                 read_mesh_vertices, transform_points)
from .panoptic_eval import PanopticEval
from .point_wise_eval import (evaluate_offset_mae, evaluate_semantic_acc,
                              evaluate_semantic_miou)
from .postprocess import get_gt_instances, get_instances, panoptic_fusion

__all__ = [
    'ScanNetEval', 'PanopticEval', 'evaluate_offset_mae',
    'evaluate_semantic_acc', 'evaluate_semantic_miou', 'get_gt_instances',
    'get_instances', 'panoptic_fusion', 'Instance', 'export_ids',
    'export_instance_ids_for_eval', 'load_ids',
    'read_instance_prediction_file', 'read_mesh_vertices',
    'transform_points',
]
