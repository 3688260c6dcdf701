"""Growth configurations as Python dictionaries.

``VESSEL_GRAPH_GEN`` holds ``configs/vessel_graph_gen.yml``: the
``Greenhouse`` and ``Forest`` sections (the reference's two-mode SVC/DVC
schedule: 100 + 150 iterations, 2000 candidates an iteration, 8 trees per
forest) and the ``output`` block of the dataset generator. The port needs no
YAML at run time; a test holds this dictionary equal to the file.
"""
from __future__ import annotations

import copy

VESSEL_GRAPH_GEN = {
    "Greenhouse": {
        "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                            "no_voxel_z": 0.0131},
        "d": 0.1,
        "r": 0.0025,
        "FAZ_radius_bound": [0.44, 0.04],
        "rotation_radius": 1.05,
        "FAZ_center": [0.5, 0.5],
        "nerve_center": [10.56, 5.16],
        "nerve_radius": 0.3,
        "param_scale": 3,
        "modes": [
            {"name": "SVC", "I": 100, "N": 2000, "eps_n": 0.18,
             "eps_s": 0.135, "eps_k": 0.135, "delta_art": 0.2925,
             "delta_ven": 0.2925, "gamma_art": 50, "gamma_ven": 50,
             "phi": 15, "omega": 0.3, "kappa": 2.55, "delta_sigma": 0.02},
            {"name": "DVC", "I": 150, "N": 2000, "eps_n": 0.09,
             "eps_s": 0.0675, "eps_k": 0.0675, "delta_art": 0.14625,
             "delta_ven": 0.14625, "gamma_art": 90, "gamma_ven": 90,
             "phi": 15, "omega": 0, "kappa": 2.9, "delta_sigma": 0.02},
        ],
    },
    "output": {
        "directory": "./results/vessel_graphs",
        "image_scale_factor": 304,
        "save_trees": True,
        "save_3D_volumes": None,
        "save_2D_image": True,
        "proj_axis": 2,
        "save_stats": False,
    },
    "Forest": {
        "type": "stumps",
        "N_trees": 8,
        "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                         "z0": False, "z1": False},
    },
}


def vessel_graph_gen() -> dict:
    """A fresh copy of ``VESSEL_GRAPH_GEN`` that the caller may edit."""
    return copy.deepcopy(VESSEL_GRAPH_GEN)
