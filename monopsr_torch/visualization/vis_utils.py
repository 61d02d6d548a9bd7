"""Drawing helpers: images, 2D boxes, projected 3D boxes.

Counterpart of ``monopsr_tpu/visualization/vis_utils.py``, drawing the
same figures. Matplotlib-based, imported inside each function, so
importing this module needs no matplotlib; used by the demos and offline
analysis, never on the training path.
"""

import numpy as np

from monopsr_torch.datasets.kitti import obj_utils
from monopsr_torch.geometry import boxes as box_geom
from monopsr_torch.geometry import projection

BOX_COLOURS = {
    'Car': 'lime',
    'Pedestrian': 'cyan',
    'Cyclist': 'yellow',
    'Van': 'orange',
    'Truck': 'orange',
    'Person_sitting': 'orange',
    'Tram': 'orange',
    'Misc': 'orange',
    'DontCare': 'grey',
}

# 3D box face index (front, right, back, left), matching the reference's
# corner convention (ref: obj_utils.py:658-677)
FACE_IDX = np.array([[0, 1, 5, 4],
                     [1, 2, 6, 5],
                     [2, 3, 7, 6],
                     [3, 0, 4, 7]])


def create_fig(image, figsize=(16, 5)):
    """Creates a figure with the image filling the axes."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, figsize=figsize)
    ax.imshow(image)
    ax.axis('off')
    return fig, ax


def plots_from_image(image, subplot_rows=1, subplot_cols=1,
                     display=False, fig_size=None):
    """Figure + axes grid with the image on every axis, limits set to
    the image extent (ref: vis_utils.py:18-63)."""
    import matplotlib.pyplot as plt

    if fig_size is None:
        shape = np.shape(image)
        fig_size = (shape[1] / 100 * subplot_cols,
                    shape[0] / 100 * subplot_rows)

    fig, axes = plt.subplots(subplot_rows, subplot_cols,
                             figsize=fig_size, sharex=True)
    fig.subplots_adjust(left=0.0, bottom=0.0, right=1.0, top=1.0,
                        hspace=0.0)

    def setup(ax):
        ax.imshow(image)
        ax.set_xlim(0, np.shape(image)[1])
        ax.set_ylim(np.shape(image)[0], 0)

    if subplot_rows == 1 and subplot_cols == 1:
        setup(axes)
    else:
        for ax in np.ravel(axes):
            setup(ax)
    if display:
        plt.show(block=False)
    return fig, axes


def get_point_colours(points, cam_p, image):
    """RGB colour per 3D point, sampled at its projected pixel
    (ref: vis_utils.py:157-164). points: (N, 3) cam-frame."""
    uv = projection.np_project_pc_to_image(np.asarray(points).T, cam_p)
    uv = np.round(uv).astype(np.int32)
    return np.asarray(image)[uv[1], uv[0]]


def draw_box_2d(ax, obj_or_box, colour=None, linewidth=2):
    """Draws a 2D box; accepts an ObjectLabel or [y1, x1, y2, x2]."""
    import matplotlib.patches as patches

    if hasattr(obj_or_box, 'x1'):
        x1, y1 = obj_or_box.x1, obj_or_box.y1
        x2, y2 = obj_or_box.x2, obj_or_box.y2
        colour = colour or BOX_COLOURS.get(obj_or_box.type, 'red')
    else:
        y1, x1, y2, x2 = obj_or_box
        colour = colour or 'red'

    ax.add_patch(patches.Rectangle(
        (x1, y1), x2 - x1, y2 - y1,
        linewidth=linewidth, edgecolor=colour, facecolor='none'))


def draw_obj_as_box_3d(ax, obj_label, cam_p, colour=None, linewidth=1.5,
                       show_orientation=False, colour_table=None,
                       double_line=False):
    """Draws the projected 3D wireframe of an ObjectLabel.

    Optional reference features (ref: vis_utils.py:201-262):
    `colour_table` (4 entries indexed by occlusion, as used for
    difficulty colouring), dashed lines for truncated objects,
    `double_line` inner stroke, and the `show_orientation` heading
    line from the box centre along +x rotated by ry.
    """
    box_3d = obj_utils.object_label_to_box_3d(obj_label)
    corners = box_geom.np_compute_box_3d_corners(box_3d)
    if np.any(corners[2] < 0.1):
        return
    uv = projection.np_project_pc_to_image(corners, cam_p)

    if colour is None and colour_table is not None:
        if len(colour_table) != 4:
            raise ValueError('colour_table must have 4 entries')
        colour = colour_table[int(obj_label.occlusion)]
    colour = colour or BOX_COLOURS.get(obj_label.type, 'red')
    linestyle = 'dashed' if obj_label.truncation > 0.1 else 'solid'

    for face in FACE_IDX:
        xs = uv[0][list(face) + [face[0]]]
        ys = uv[1][list(face) + [face[0]]]
        ax.plot(xs, ys, color=colour, linewidth=linewidth,
                linestyle=linestyle)
        if double_line:
            ax.plot(xs, ys, color='b', linewidth=linewidth / 3.0)

    if show_orientation:
        ry = obj_label.ry
        length = obj_label.l
        ends = np.array([[0.0, length * np.cos(ry)],
                         [0.0, 0.0],
                         [0.0, -length * np.sin(ry)]])
        ends = ends + np.asarray(obj_label.t, np.float64)[:, None]
        if np.all(ends[2] > 0.1):
            ouv = projection.np_project_pc_to_image(ends, cam_p)
            ax.plot(ouv[0], ouv[1], linewidth=4, color='w')
            ax.plot(ouv[0], ouv[1], linewidth=2, color='k')


def draw_instance_masks(image, instance_img, alpha=0.5):
    """Overlays coloured instance masks on an image; returns the blend."""
    import matplotlib

    out = np.asarray(image, np.float32).copy()
    ids = np.unique(instance_img)
    ids = ids[ids != 255]
    cmap = matplotlib.colormaps['tab20']
    for idx in ids:
        mask = instance_img == idx
        colour = np.asarray(cmap(int(idx) % 20)[:3]) * 255.0
        out[mask] = (1 - alpha) * out[mask] + alpha * colour
    return out.astype(np.uint8)


def save_fig(fig, path, dpi=100):
    """Saves a figure (tight bounding box) and closes it."""
    fig.savefig(path, bbox_inches='tight', dpi=dpi)
    import matplotlib.pyplot as plt
    plt.close(fig)
