"""Data parallelism over ``torch.distributed`` ranks (port of
carla_garage_tpu/parallel/): the mesh and its collectives (``mesh``), the
rank launcher (``launch``) and the multi-device dry run (``dryrun``)."""
