"""Logical-axis sharding rules of the port (`axes`), mapped onto torch
DeviceMesh placements."""
