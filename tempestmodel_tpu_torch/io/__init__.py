"""Diagnostics, lat-lon and NetCDF output, the arena packer and the output
managers of the driver."""
