"""Asset constants (counterpart of airgym_tpu/assets/__init__.py).

Only what the ported tasks read: Balloon's ground-collision radius. The
asset registry, scene tables and URDF geometry are ROADMAP.md queue A
item 11.
"""

ROBOT_COLLISION_RADIUS = 0.2  # X152b/model.urdf:16
