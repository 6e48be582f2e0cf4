from .recovery import ElasticPlan, MeshPlan, StepWatchdog, TrainingRunner
