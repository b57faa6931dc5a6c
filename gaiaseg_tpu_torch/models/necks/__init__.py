from .multilevel_neck import DynamicMultiLevelNeck

__all__ = ["DynamicMultiLevelNeck"]
