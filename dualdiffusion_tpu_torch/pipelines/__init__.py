from .pipeline import (Pipeline, ModuleHandle, register_module, get_module_class, save_module,
                       load_module)
