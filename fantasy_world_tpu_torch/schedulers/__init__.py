from .flow_match import FlowMatchScheduler
from .continuous_ode import ContinuousODEScheduler
from .ddim import EnhancedDDIMScheduler
