"""FARSI core on PyTorch: the hybrid simulator and the aware explorer.

Public API re-exports. The batched backend (``backend="torch"``) prices on
the card unless the caller asks for the CPU.
"""
from .backend import (
    BackendStats,
    Candidate,
    PythonBackend,
    SimHandle,
    SimTelemetry,
    SimulatorBackend,
    TorchBatchedBackend,
    make_backend,
)
from .blocks import Block, BlockKind, make_accelerator, make_gpp, make_mem, make_noc
from .budgets import Budget, Distance, distance
from .codesign import CodesignLedger, FocusRecord
from .database import HardwareDatabase, TPUDatabase
from .design import Design
from .design_space import random_single_noc_designs
from .device_explore import (
    ChainBlockResult,
    ChainCarry,
    ChainRequest,
    DeviceChainRunner,
    MoveTable,
    reconcile_alloc,
)
from .explorer import AWARENESS_LEVELS, ExplorationResult, Explorer, ExplorerConfig
from .gables import TaskRates, bottleneck_of, completion_time, phase_rates
from .phase_sim import SimResult, simulate
from .policy import (
    POLICIES,
    BottleneckRelaxation,
    DevCostPolicy,
    DeviceSA,
    FarsiPolicy,
    Focus,
    HeuristicPolicy,
    LocalityExploitation,
    NaiveSA,
    make_policy,
)
from .tdg import Task, TaskGraph, merge_graphs, workload_of
from .workloads import (
    Scenario,
    all_workloads,
    ar_complex,
    audio,
    calibrated_budget,
    cava,
    edge_detection,
    paper_budget,
    synthetic_family,
)

# last: the campaign's engine is the serve layer, which builds on this package
from .campaign import Campaign, CampaignResult, RunSpec  # noqa: E402

__all__ = [
    "AWARENESS_LEVELS",
    "BackendStats",
    "Block",
    "BlockKind",
    "BottleneckRelaxation",
    "Budget",
    "Campaign",
    "CampaignResult",
    "Candidate",
    "ChainBlockResult",
    "ChainCarry",
    "ChainRequest",
    "CodesignLedger",
    "Design",
    "DevCostPolicy",
    "DeviceChainRunner",
    "DeviceSA",
    "Distance",
    "ExplorationResult",
    "Explorer",
    "ExplorerConfig",
    "FarsiPolicy",
    "Focus",
    "FocusRecord",
    "HardwareDatabase",
    "HeuristicPolicy",
    "LocalityExploitation",
    "MoveTable",
    "NaiveSA",
    "POLICIES",
    "PythonBackend",
    "RunSpec",
    "Scenario",
    "SimHandle",
    "SimResult",
    "SimTelemetry",
    "SimulatorBackend",
    "TPUDatabase",
    "Task",
    "TaskGraph",
    "TaskRates",
    "TorchBatchedBackend",
    "all_workloads",
    "ar_complex",
    "audio",
    "bottleneck_of",
    "calibrated_budget",
    "cava",
    "completion_time",
    "distance",
    "edge_detection",
    "make_accelerator",
    "make_backend",
    "make_gpp",
    "make_mem",
    "make_noc",
    "make_policy",
    "merge_graphs",
    "paper_budget",
    "phase_rates",
    "random_single_noc_designs",
    "reconcile_alloc",
    "simulate",
    "synthetic_family",
    "workload_of",
]
