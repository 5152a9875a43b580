from .bst import BinarySearchStore
from .storage import (
    AttributeDict,
    CompressedStorage,
    MeshStorage,
    SkeletonStorage,
    VoxelStorage,
    VoxelStorageClass,
    VoxelStorageDyn,
    VoxelStorageL,
    VoxelStorageLazyLoading,
)

__all__ = [
    "BinarySearchStore",
    "AttributeDict",
    "CompressedStorage",
    "MeshStorage",
    "SkeletonStorage",
    "VoxelStorage",
    "VoxelStorageClass",
    "VoxelStorageDyn",
    "VoxelStorageL",
    "VoxelStorageLazyLoading",
]
