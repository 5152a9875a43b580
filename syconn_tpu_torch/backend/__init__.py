from .storage import (
    AttributeDict,
    CompressedStorage,
    MeshStorage,
    SkeletonStorage,
    VoxelStorage,
    VoxelStorageDyn,
    VoxelStorageLazyLoading,
)

__all__ = [
    "AttributeDict",
    "CompressedStorage",
    "MeshStorage",
    "SkeletonStorage",
    "VoxelStorage",
    "VoxelStorageDyn",
    "VoxelStorageLazyLoading",
]
