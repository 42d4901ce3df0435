"""Task-level default config tree.

Re-provides the habitat task config surface the reference task YAMLs assume
(reference habitat_extensions/config/default.py:1-171 plus the Habitat-Lab
defaults they extend), so reference experiment files port 1:1. Keys are the
public API, shared with the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Union

from vlnce_torch.config.node import Config as CN

_C = CN()

# -----------------------------------------------------------------------------
# ENVIRONMENT
# -----------------------------------------------------------------------------
_C.ENVIRONMENT = CN()
_C.ENVIRONMENT.MAX_EPISODE_STEPS = 500
_C.ENVIRONMENT.MAX_EPISODE_SECONDS = 10_000_000
_C.ENVIRONMENT.ITERATOR_OPTIONS = CN()
_C.ENVIRONMENT.ITERATOR_OPTIONS.CYCLE = True
_C.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = True
_C.ENVIRONMENT.ITERATOR_OPTIONS.GROUP_BY_SCENE = True
_C.ENVIRONMENT.ITERATOR_OPTIONS.NUM_EPISODE_SAMPLE = -1
_C.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_EPISODES = -1
_C.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = 10_000
_C.ENVIRONMENT.ITERATOR_OPTIONS.STEP_REPETITION_RANGE = 0.2

# -----------------------------------------------------------------------------
# SIMULATOR
# -----------------------------------------------------------------------------
_C.SIMULATOR = CN()
# default backend: procedural grid-world (pure host-side numpy).
# "HabitatSim-v0" selects the Habitat-Sim adapter when habitat_sim is present.
_C.SIMULATOR.TYPE = "GridWorldSim-v0"
_C.SIMULATOR.ACTION_SPACE_CONFIG = "v0"
_C.SIMULATOR.FORWARD_STEP_SIZE = 0.25  # meters
_C.SIMULATOR.TURN_ANGLE = 15  # degrees
_C.SIMULATOR.TILT_ANGLE = 15  # degrees
_C.SIMULATOR.DEFAULT_AGENT_ID = 0
_C.SIMULATOR.SEED = 100
_C.SIMULATOR.SCENE = ""
# real-scene geometry for the occupancy-grid twin (envs/scene_import.py):
# a directory of exported {scene_stem}.npz grids, and/or the reference's
# data/connectivity_graphs.pkl to rasterize on first use
_C.SIMULATOR.GEOMETRY_DIR = ""
_C.SIMULATOR.CONNECTIVITY_GRAPHS = ""
_C.SIMULATOR.HABITAT_SIM_V0 = CN()
_C.SIMULATOR.HABITAT_SIM_V0.GPU_DEVICE_ID = 0
_C.SIMULATOR.HABITAT_SIM_V0.ALLOW_SLIDING = True
_C.SIMULATOR.HABITAT_SIM_V0.GPU_GPU = False

_C.SIMULATOR.AGENT_0 = CN()
_C.SIMULATOR.AGENT_0.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
_C.SIMULATOR.AGENT_0.HEIGHT = 1.5
_C.SIMULATOR.AGENT_0.RADIUS = 0.1
_C.SIMULATOR.AGENT_0.START_POSITION = [0.0, 0.0, 0.0]
_C.SIMULATOR.AGENT_0.START_ROTATION = [0.0, 0.0, 0.0, 1.0]
_C.SIMULATOR.AGENT_0.IS_SET_START_STATE = False
_C.SIMULATOR.AGENTS = ["AGENT_0"]


def _camera_sensor(uuid: str, h: int, w: int) -> CN:
    c = CN()
    c.TYPE = ""
    c.UUID = uuid
    c.HEIGHT = h
    c.WIDTH = w
    c.HFOV = 90
    c.POSITION = [0.0, 1.25, 0.0]
    c.ORIENTATION = [0.0, 0.0, 0.0]  # Euler angles (x=tilt, y=pan, z=roll)
    return c


_C.SIMULATOR.RGB_SENSOR = _camera_sensor("rgb", 224, 224)
_C.SIMULATOR.RGB_SENSOR.TYPE = "HabitatSimRGBSensor"

_C.SIMULATOR.DEPTH_SENSOR = _camera_sensor("depth", 256, 256)
_C.SIMULATOR.DEPTH_SENSOR.TYPE = "HabitatSimDepthSensor"
_C.SIMULATOR.DEPTH_SENSOR.MIN_DEPTH = 0.0
_C.SIMULATOR.DEPTH_SENSOR.MAX_DEPTH = 10.0
_C.SIMULATOR.DEPTH_SENSOR.NORMALIZE_DEPTH = True

# -----------------------------------------------------------------------------
# TASK
# -----------------------------------------------------------------------------
_C.TASK = CN()
_C.TASK.TYPE = "VLN-v0"
_C.TASK.SUCCESS_DISTANCE = 3.0
_C.TASK.SENSORS = []
_C.TASK.MEASUREMENTS = []
_C.TASK.POSSIBLE_ACTIONS = ["STOP", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]
_C.TASK.INSTRUCTION_SENSOR_UUID = "instruction"
_C.TASK.PANO_ROTATIONS = 12  # reference habitat_extensions/config/default.py:12

_C.TASK.ACTIONS = CN()
_C.TASK.ACTIONS.STOP = CN()
_C.TASK.ACTIONS.STOP.TYPE = "StopAction"
_C.TASK.ACTIONS.MOVE_FORWARD = CN()
_C.TASK.ACTIONS.MOVE_FORWARD.TYPE = "MoveForwardAction"
_C.TASK.ACTIONS.TURN_LEFT = CN()
_C.TASK.ACTIONS.TURN_LEFT.TYPE = "TurnLeftAction"
_C.TASK.ACTIONS.TURN_RIGHT = CN()
_C.TASK.ACTIONS.TURN_RIGHT.TYPE = "TurnRightAction"
_C.TASK.ACTIONS.LOOK_UP = CN()
_C.TASK.ACTIONS.LOOK_UP.TYPE = "LookUpAction"
_C.TASK.ACTIONS.LOOK_DOWN = CN()
_C.TASK.ACTIONS.LOOK_DOWN.TYPE = "LookDownAction"
_C.TASK.ACTIONS.TELEPORT = CN()
_C.TASK.ACTIONS.TELEPORT.TYPE = "TeleportAction"
# Waypoint action (reference habitat_extensions/actions.py:15-74)
_C.TASK.ACTIONS.GO_TOWARD_POINT = CN()
_C.TASK.ACTIONS.GO_TOWARD_POINT.TYPE = "GoTowardPoint"
_C.TASK.ACTIONS.GO_TOWARD_POINT.rotate_agent = True

# --- sensors -----------------------------------------------------------------
_C.TASK.INSTRUCTION_SENSOR = CN()
_C.TASK.INSTRUCTION_SENSOR.TYPE = "InstructionSensor"

_C.TASK.HEADING_SENSOR = CN()
_C.TASK.HEADING_SENSOR.TYPE = "HeadingSensor"

_C.TASK.GLOBAL_GPS_SENSOR = CN()
_C.TASK.GLOBAL_GPS_SENSOR.TYPE = "GlobalGPSSensor"
_C.TASK.GLOBAL_GPS_SENSOR.DIMENSIONALITY = 2

_C.TASK.ORACLE_ACTION_SENSOR = CN()
_C.TASK.ORACLE_ACTION_SENSOR.TYPE = "OracleActionSensor"
_C.TASK.ORACLE_ACTION_SENSOR.GOAL_RADIUS = 0.5

_C.TASK.RXR_INSTRUCTION_SENSOR = CN()
_C.TASK.RXR_INSTRUCTION_SENSOR.TYPE = "RxRInstructionSensor"
_C.TASK.RXR_INSTRUCTION_SENSOR.features_path = (
    "data/datasets/RxR_VLNCE_v0/text_features/rxr_{split}/{id:06}_{lang}_text_features.npz"
)
_C.TASK.RXR_INSTRUCTION_SENSOR.max_text_len = 512
_C.TASK.RXR_INSTRUCTION_SENSOR.feature_dim = 768

_C.TASK.SHORTEST_PATH_SENSOR = CN()
_C.TASK.SHORTEST_PATH_SENSOR.TYPE = "ShortestPathSensor"
_C.TASK.SHORTEST_PATH_SENSOR.GOAL_RADIUS = 0.5
_C.TASK.SHORTEST_PATH_SENSOR.USE_ORIGINAL_FOLLOWER = False

_C.TASK.VLN_ORACLE_PROGRESS_SENSOR = CN()
_C.TASK.VLN_ORACLE_PROGRESS_SENSOR.TYPE = "VLNOracleProgressSensor"

_C.TASK.PANO_ANGLE_FEATURE_SENSOR = CN()
_C.TASK.PANO_ANGLE_FEATURE_SENSOR.TYPE = "AngleFeaturesSensor"
_C.TASK.PANO_ANGLE_FEATURE_SENSOR.CAMERA_NUM = 12

# --- measures ----------------------------------------------------------------
_C.TASK.DISTANCE_TO_GOAL = CN()
_C.TASK.DISTANCE_TO_GOAL.TYPE = "DistanceToGoal"
_C.TASK.DISTANCE_TO_GOAL.DISTANCE_TO = "POINT"

_C.TASK.SUCCESS = CN()
_C.TASK.SUCCESS.TYPE = "Success"
_C.TASK.SUCCESS.SUCCESS_DISTANCE = 3.0

_C.TASK.SPL = CN()
_C.TASK.SPL.TYPE = "SPL"
_C.TASK.SPL.SUCCESS_DISTANCE = 3.0

_C.TASK.NDTW = CN()
_C.TASK.NDTW.TYPE = "NDTW"
_C.TASK.NDTW.SPLIT = "val_seen"
_C.TASK.NDTW.FDTW = True  # False: exact DTW
_C.TASK.NDTW.GT_PATH = "data/datasets/R2R_VLNCE_v1-3_preprocessed/{split}/{split}_gt.json.gz"
_C.TASK.NDTW.SUCCESS_DISTANCE = 3.0

_C.TASK.SDTW = CN()
_C.TASK.SDTW.TYPE = "SDTW"

_C.TASK.PATH_LENGTH = CN()
_C.TASK.PATH_LENGTH.TYPE = "PathLength"

_C.TASK.ORACLE_NAVIGATION_ERROR = CN()
_C.TASK.ORACLE_NAVIGATION_ERROR.TYPE = "OracleNavigationError"

_C.TASK.ORACLE_SUCCESS = CN()
_C.TASK.ORACLE_SUCCESS.TYPE = "OracleSuccess"
_C.TASK.ORACLE_SUCCESS.SUCCESS_DISTANCE = 3.0

_C.TASK.ORACLE_SPL = CN()
_C.TASK.ORACLE_SPL.TYPE = "OracleSPL"

_C.TASK.STEPS_TAKEN = CN()
_C.TASK.STEPS_TAKEN.TYPE = "StepsTaken"

_C.TASK.TOP_DOWN_MAP_VLNCE = CN()
_C.TASK.TOP_DOWN_MAP_VLNCE.TYPE = "TopDownMapVLNCE"
_C.TASK.TOP_DOWN_MAP_VLNCE.MAX_EPISODE_STEPS = _C.ENVIRONMENT.MAX_EPISODE_STEPS
_C.TASK.TOP_DOWN_MAP_VLNCE.MAP_RESOLUTION = 1024
_C.TASK.TOP_DOWN_MAP_VLNCE.DRAW_SOURCE_AND_TARGET = True
_C.TASK.TOP_DOWN_MAP_VLNCE.DRAW_BORDER = True
_C.TASK.TOP_DOWN_MAP_VLNCE.DRAW_SHORTEST_PATH = True
_C.TASK.TOP_DOWN_MAP_VLNCE.DRAW_REFERENCE_PATH = True
_C.TASK.TOP_DOWN_MAP_VLNCE.DRAW_FIXED_WAYPOINTS = True
_C.TASK.TOP_DOWN_MAP_VLNCE.DRAW_MP3D_AGENT_PATH = True
_C.TASK.TOP_DOWN_MAP_VLNCE.GRAPHS_FILE = "data/connectivity_graphs.pkl"
_C.TASK.TOP_DOWN_MAP_VLNCE.FOG_OF_WAR = CN()
_C.TASK.TOP_DOWN_MAP_VLNCE.FOG_OF_WAR.DRAW = True
_C.TASK.TOP_DOWN_MAP_VLNCE.FOG_OF_WAR.FOV = 90
_C.TASK.TOP_DOWN_MAP_VLNCE.FOG_OF_WAR.VISIBILITY_DIST = 5.0

_C.TASK.WAYPOINT_REWARD_MEASURE = CN()
_C.TASK.WAYPOINT_REWARD_MEASURE.TYPE = "WaypointRewardMeasure"
_C.TASK.WAYPOINT_REWARD_MEASURE.use_distance_scaled_slack_reward = True
_C.TASK.WAYPOINT_REWARD_MEASURE.scale_slack_on_prediction = True
_C.TASK.WAYPOINT_REWARD_MEASURE.success_reward = 2.5
_C.TASK.WAYPOINT_REWARD_MEASURE.distance_scalar = 1.0
_C.TASK.WAYPOINT_REWARD_MEASURE.slack_reward = -0.05

# -----------------------------------------------------------------------------
# DATASET
# -----------------------------------------------------------------------------
_C.DATASET = CN()
_C.DATASET.TYPE = "VLN-CE-v1"
_C.DATASET.SPLIT = "train"
_C.DATASET.SCENES_DIR = "data/scene_datasets/"
_C.DATASET.CONTENT_SCENES = ["*"]
_C.DATASET.DATA_PATH = "data/datasets/R2R_VLNCE_v1-3_preprocessed/{split}/{split}.json.gz"
# extensions (reference habitat_extensions/config/default.py:133-137)
_C.DATASET.NUM_EPISODES = 64  # synthetic dataset only
_C.DATASET.NUM_SCENES = 4  # synthetic dataset only
_C.DATASET.ROLES = ["guide"]  # options: "guide", "follower"
_C.DATASET.LANGUAGES = ["*"]  # options: "te-IN", "hi-IN", "en-US", "en-IN"
_C.DATASET.EPISODES_ALLOWED = ["*"]

_C.SEED = 100


def get_default_task_config() -> CN:
    return _C.clone()


def get_extended_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
) -> CN:
    """Build a task config: defaults <- YAML file(s) <- CLI opts.

    Mirrors reference habitat_extensions/config/default.py:140-170, including
    syncing NDTW.SPLIT to DATASET.SPLIT before freezing.
    """
    config = _C.clone()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = config_paths.split(",") if "," in config_paths else [config_paths]
        for path in config_paths:
            config.merge_from_file(path)
    if opts:
        config.merge_from_list(list(opts))
    config.TASK.NDTW.SPLIT = config.DATASET.SPLIT
    config.freeze()
    return config
