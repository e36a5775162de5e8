"""ResNet backbone, 3D sine position encoding, temporal deformable
transformer and the Snipper model."""
