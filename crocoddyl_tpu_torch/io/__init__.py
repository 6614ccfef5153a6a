"""IO layer: native URDF robot loading and problem conversion."""
