"""The multi-device launch layer: rank meshes, the sharded serve step, the
decode cells and the serving launcher."""
